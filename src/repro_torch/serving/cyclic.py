"""Scan-cycle serving: the paper's multipart inference (§6.3) applied to LLM
decode (``repro.serving.cyclic``'s counterpart).

On the PLC, one inference is sliced into segments so that each scan cycle
pays a bounded, predictable cost and the control task always meets its
deadline.  For a decoder the natural segment is a **layer block**: each
cycle advances one contiguous block of layers for the in-flight token.  The
carry between cycles is the hidden state and the cache arena, whose layer
slices each segment updates in place — the ICSML arena crossing scan
cycles.  Segment bounds follow ``np.linspace(0, n_layers, n_segments + 1)``
as in the reference.  A cycle ends when its segment's work has finished on
the device (the decoder synchronises the card after each segment), so a
cycle time is the segment's real cost.

Supported families: ``dense``, ``moe`` and ``vlm`` (transformer block
stacks; the vlm's image prefix is in the arena its prefill filled) and
``ssm``; ``hybrid`` and ``audio`` raise, as the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import Device, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe as moelib
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class CycleStats:
    cycle_times_s: List[float]
    tokens: List[int]
    cycles_per_token: int


class CyclicDecoder:
    """Multipart decode: one layer segment per scan cycle.  Runs on the card
    unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: ArchConfig, params: Any, *, n_segments: int,
                 batch: int, cache_len: int, backend: kops.Backend = "auto",
                 device: Device = "cuda"):
        if cfg.family not in ("dense", "moe", "vlm", "ssm"):
            raise NotImplementedError(
                f"CyclicDecoder serves the dense, moe, vlm and ssm families, "
                f"not {cfg.family!r}")
        if cfg.kv_quant:
            raise NotImplementedError(
                "CyclicDecoder does not compose with kv_quant: its segment "
                "cache carries only (k, v), not the int8 scales.")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.cache_len = cache_len
        self.backend = backend
        n_layers = cfg.n_layers
        n_segments = max(1, min(n_segments, n_layers))
        bounds = np.linspace(0, n_layers, n_segments + 1).astype(int)
        self.bounds = [(int(a), int(b)) for a, b in zip(bounds[:-1],
                                                        bounds[1:])]
        self.n_segments = len(self.bounds)
        if cfg.family == "moe":
            self._ffn = moelib.make_ffn_apply(cfg)
        else:
            self._ffn = tf._dense_ffn(cfg, backend)

    def _segment(self, start: int, stop: int, cache: Any, h: torch.Tensor,
                 pos: torch.Tensor, multi: bool) -> torch.Tensor:
        """Layers [start, stop) for every row: the hidden state out, each
        layer's slice of ``cache`` updated in place."""
        cfg, blocks = self.cfg, self.params["blocks"]
        for layer in range(start, stop):
            blk = cm.layer_slice(blocks, layer)
            if cfg.family == "ssm":
                out, new = mb.mamba_decode(
                    blk["mixer"], cfg, cm.rmsnorm(blk["ln"], h),
                    {"conv": cache["conv"][layer], "ssm": cache["ssm"][layer]},
                    backend=self.backend)
                cache["conv"][layer].copy_(new["conv"])
                cache["ssm"][layer].copy_(new["ssm"])
                h = h + out
            else:
                step = tf.block_decode_multi if multi else tf.block_decode
                h, _ = step(blk, cfg, h, pos,
                            (cache["k"][layer], cache["v"][layer]),
                            self._ffn, backend=self.backend)
        return h

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return cm.embed(self.params["embed"], tokens).to(self.cfg.dtype)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return cm.unembed(self.params["embed"],
                          cm.rmsnorm(self.params["final_norm"], h))

    def decode_step_multi(self, cache: Any, tokens: torch.Tensor,
                          pos: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        """One multipart decode step with per-slot positions.

        tokens (B, 1), pos (B,) — the continuous engine's step run as
        ``n_segments`` bounded cycles, each advancing one layer block for
        **all** in-flight slots.  Returns (cache, logits (B, 1, V)), the
        contract of ``ModelAPI.decode_multi``; the cache is updated in
        place."""
        h = self._embed(tokens)
        pos = torch.as_tensor(pos, device=tokens.device)
        for a, b in self.bounds:
            h = self._segment(a, b, cache, h, pos, multi=True)
        return cache, self._logits(h)

    def decode_tokens(
        self, cache: Any, first_token: torch.Tensor, start_pos: int,
        n_tokens: int, control_task: Optional[Callable[[], None]] = None,
    ) -> Tuple[List[int], Any, CycleStats]:
        """Generate ``n_tokens`` greedily after ``first_token``, advancing
        one segment per scan cycle.  ``control_task`` is invoked once per
        cycle before the segment — the PLC's primary workload in the §7.2
        non-intrusiveness sense.  Returns row 0's tokens."""
        tokens: List[int] = []
        cycle_times: List[float] = []
        cur = first_token.reshape(self.batch, 1).to(self.device)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda _: None)
        pos = start_pos
        for _ in range(n_tokens):
            h = self._embed(cur)
            pos_t = torch.tensor(pos, device=self.device)
            for a, b in self.bounds:
                t0 = time.perf_counter()
                if control_task is not None:
                    control_task()
                h = self._segment(a, b, cache, h, pos_t, multi=False)
                sync(self.device)
                cycle_times.append(time.perf_counter() - t0)
            nxt = torch.argmax(self._logits(h)[:, -1], dim=-1)
            tokens.append(int(nxt[0]))
            cur = nxt[:, None]
            pos += 1
        return tokens, cache, CycleStats(cycle_times_s=cycle_times,
                                         tokens=tokens,
                                         cycles_per_token=self.n_segments)
