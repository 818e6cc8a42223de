"""Continuous-batching serving engine: per-slot state around one fixed-shape
decode step (``repro.serving.continuous``'s counterpart).

The wave engine (serving/engine.py) shares one position counter across the
batch, so every slot stalls until the wave's longest request finishes.  This
engine keeps the same ICSML discipline — one statically preallocated cache
arena, updated in place step after step, no allocation of serving state
after construction — but tracks **per-slot positions, temperatures and
done-masks**, so a slot is re-admitted the moment its occupant retires (EOS,
max tokens, or the cache's end).

Admission writes a new request's prompt into its slot of the arena:

* the dense family prefills ``prompt[:-1]`` right-padded to a fixed bucket
  length.  Pad positions land beyond the slot's live region and each decode
  step overwrites its own position before attending to it, so pads are
  never observed.
* ssm (recurrent state absorbs pads), moe (pad tokens would compete for
  expert capacity) and hybrid (both) prefill at the exact prompt length
  instead.  The moe and hybrid dispatch needs ``len(prompt) - 1`` to be at
  most ``cfg.moe_group`` or a multiple of it.

The prefilled single-request cache is copied in place into the slot along
the slot axis, which is found generically by diffing ``cache_specs`` at two
batch sizes (:func:`_batch_axes`) — no per-family layout knowledge here.

Decode is one fixed-shape step over all slots: ``decode_multi`` (per-slot
positions), then per-slot temperature sampling with the engine's one
``torch.Generator`` (greedy rows take the argmax, so greedy tokens equal the
reference's; hot rows match it only in distribution), then done-masked
outputs.  Inactive slots decode token 0 at their last position, as in the
reference (a write past the cache's end lands on its last row, where
``lax.dynamic_update_slice`` clamps it).  ``cyclic_segments > 0`` runs the
step through a :class:`~repro_torch.serving.cyclic.CyclicDecoder`, so the
paper's multipart inference (§6.3) composes with continuous slots.  The
engine runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import Device, resolve_device
from repro_torch.models.api import ModelAPI
from repro_torch.serving.cyclic import CyclicDecoder
from repro_torch.serving.engine import (Completion, Request, _truncate_eos,
                                        sample_batched)

# Families whose decode is a pure function of the attention cache: the
# right-padded bucket prefill is safe.  moe is excluded (pad tokens would
# compete for expert capacity during prefill).  During decode, capacity-
# grouped MoE routing couples the rows decoded together, in any engine.
_BUCKET_FAMILIES = ("dense",)


@dataclasses.dataclass
class _Slot:
    req: Request
    out: List[int]
    admitted_s: float         # serve-clock time admission finished
    # Host time to enqueue the admission's prefill and slot insert: nothing
    # waits for the card there, so its device time runs on into the next
    # step (the ``engine.admit`` span's events time it on the card).
    prefill_s: float


@dataclasses.dataclass
class ServeStats:
    steps: int                # decode steps executed
    admitted: int             # requests admitted into slots
    wall_s: float             # total serve() wall time


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order (the order of
    ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _batch_axes(api: ModelAPI, cache_len: int) -> List[int]:
    """Per-leaf batch axis of the cache, found by diffing two batch sizes."""
    axes = []
    for a, b in zip(_leaves(api.cache_specs(1, cache_len)),
                    _leaves(api.cache_specs(2, cache_len))):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y]
        if len(diff) != 1:
            raise ValueError(f"ambiguous batch axis for {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        axes.append(diff[0])
    return axes


class ContinuousEngine:
    """Slot-scheduled serving over a :class:`ModelAPI` (continuous
    batching).

    ``prefill_bucket`` fixes the admission-prefill length for the dense
    family (defaults to cache_len // 2); prompts longer than the bucket
    fall back to exact-length prefill.  ``cyclic_segments > 0`` routes the
    decode step through a CyclicDecoder with that many layer segments per
    step.

    ``Completion.prefill_s`` is the host time an admission took to enqueue
    its prefill and slot insert, not its device time: nothing waits for
    the card until the step's read-back, so the admission's kernels finish
    inside the next step's wall time.  With :mod:`repro_torch.trace` on,
    each admission's ``engine.admit`` span and each step's ``engine.step``
    span time them on the card.
    """

    def __init__(self, api: ModelAPI, params: Any, *, batch_slots: int,
                 cache_len: int, prefill_bucket: Optional[int] = None,
                 seed: int = 0, cyclic_segments: int = 0,
                 device: Device = "cuda"):
        if api.cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                "ContinuousEngine serves token-only families; vlm/audio "
                "admission needs per-request extras (image_emb/frames): "
                "use the wave Engine with `extras` for those, as the "
                "reference.")
        if cyclic_segments > 0 and api.cfg.kv_quant:
            raise NotImplementedError(
                "cyclic_segments does not compose with kv_quant: the "
                "CyclicDecoder segment cache carries only (k, v), not the "
                "int8 scales.")
        self.device = resolve_device(device)
        self.api = api
        self.params = params
        self.batch_slots = batch_slots
        self.cache_len = cache_len
        self._bucket = (min(prefill_bucket or max(cache_len // 2, 1),
                            cache_len)
                        if api.cfg.family in _BUCKET_FAMILIES else None)
        self._axes = _batch_axes(api, cache_len)
        # The static arena, zeroed at the start of every serve() (the
        # reference starts each serve from a fresh zero cache).
        self.cache = api.init_cache(batch_slots, cache_len,
                                    device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.last_stats: Optional[ServeStats] = None
        self._cyclic = None
        if cyclic_segments > 0:
            self._cyclic = CyclicDecoder(
                api.cfg, params, n_segments=cyclic_segments,
                batch=batch_slots, cache_len=cache_len, backend=api.backend,
                device=self.device)

    # -- admission ---------------------------------------------------------

    def _slot_prefill(self, prompt: np.ndarray) -> Optional[Any]:
        """Single-request cache for ``prompt[:-1]`` (the last prompt token
        goes through the first decode step, which yields the true
        first-token logits even when the prefill window is right-padded);
        None for a one-token prompt (the slot's state is zeros)."""
        body = np.asarray(prompt[:-1], np.int64)
        if len(body) == 0:
            return None
        if self._bucket is not None and len(body) <= self._bucket:
            padded = np.zeros((self._bucket,), np.int64)
            padded[:len(body)] = body
            body = padded
        cache, _ = self.api.prefill(
            self.params, {"tokens": torch.from_numpy(body[None]).to(
                self.device)}, self.cache_len)
        return cache

    def _insert(self, part: Optional[Any], slot: int) -> None:
        """Copy a single-request cache into ``slot`` of the arena, in place
        along each leaf's slot axis (zeros when ``part`` is None)."""
        parts = _leaves(part) if part is not None else None
        for i, (leaf, ax) in enumerate(zip(_leaves(self.cache), self._axes)):
            dst = leaf.narrow(ax, slot, 1)
            if parts is None:
                dst.zero_()
            else:
                dst.copy_(parts[i])

    def _step(self, tokens: torch.Tensor, pos: torch.Tensor):
        if self._cyclic is not None:
            return self._cyclic.decode_step_multi(self.cache, tokens, pos)
        return self.api.decode_multi(self.params, self.cache,
                                     {"tokens": tokens}, pos)

    # -- serve -------------------------------------------------------------

    def serve(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve all requests, admitting into slots as they free up.

        Completions are returned in retirement order; ``finished_s`` is the
        per-request latency from serve() start (all requests are treated as
        submitted at t0)."""
        with trace.span("engine.serve"):
            return self._serve(requests)

    def _serve(self, requests: Sequence[Request]) -> List[Completion]:
        b = self.batch_slots
        pending = collections.deque(requests)
        slots: List[Optional[_Slot]] = [None] * b
        done: List[Completion] = []
        for leaf in _leaves(self.cache):
            leaf.zero_()
        tokens = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        active = np.zeros((b,), bool)
        steps = admitted = 0
        t0 = time.perf_counter()

        while pending or any(s is not None for s in slots):
            # admit into every free slot
            for i in range(b):
                if slots[i] is not None or not pending:
                    continue
                r = pending.popleft()
                plen = len(r.prompt)
                if not 1 <= plen < self.cache_len:
                    raise ValueError(f"prompt length {plen} must fit the "
                                     f"cache ({self.cache_len})")
                if r.max_new_tokens < 1:
                    raise ValueError("max_new_tokens must be >= 1 (every "
                                     "admitted slot decodes)")
                with trace.span("engine.admit", uid=r.uid,
                                device=self.device):
                    tp = time.perf_counter()
                    self._insert(self._slot_prefill(r.prompt), i)
                    prefill_s = time.perf_counter() - tp
                pos[i] = plen - 1
                tokens[i, 0] = r.prompt[-1]
                temps[i] = r.temperature
                active[i] = True
                admitted += 1
                slots[i] = _Slot(req=r, out=[],
                                 admitted_s=time.perf_counter() - t0,
                                 prefill_s=prefill_s)

            # one fixed-shape step for every slot
            with trace.span("engine.step", device=self.device):
                _, logits = self._step(
                    torch.from_numpy(tokens).to(self.device),
                    torch.from_numpy(pos).to(self.device))
                nxt = sample_batched(logits[:, -1],
                                     torch.from_numpy(temps).to(self.device),
                                     self._generator)
                nxt_h = np.where(active, nxt.cpu().numpy(), 0)
            if trace.enabled():
                trace.count("engine.slot_steps", b)
                trace.count("engine.active_slot_steps", active.sum())
            pos = np.where(active, pos + 1, pos)
            steps += 1

            # retire finished occupants, keep the rest decoding
            for i in range(b):
                s = slots[i]
                if s is None:
                    continue
                tok = int(nxt_h[i])
                s.out.append(tok)
                hit_eos = (s.req.eos_token is not None
                           and tok == s.req.eos_token)
                full = len(s.out) >= s.req.max_new_tokens
                # pos is the *next* write index; the last valid cache
                # position is cache_len - 1
                wall = int(pos[i]) >= self.cache_len
                if hit_eos or full or wall:
                    t_done = time.perf_counter() - t0
                    done.append(Completion(
                        uid=s.req.uid,
                        tokens=_truncate_eos(np.asarray(s.out, np.int64),
                                             s.req.eos_token),
                        prefill_s=s.prefill_s,
                        decode_s=t_done - s.admitted_s,
                        finished_s=t_done,
                    ))
                    slots[i] = None
                    active[i] = False
                    temps[i] = 0.0
                    tokens[i, 0] = 0
                else:
                    tokens[i, 0] = tok

        self.last_stats = ServeStats(steps=steps, admitted=admitted,
                                     wall_s=time.perf_counter() - t0)
        return done
