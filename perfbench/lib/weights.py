"""Weights drawn on the card from ``--seed``, the same for both sides.

A template names every leaf of a parameter tree with its shape and type.
Each leaf is drawn from a generator of its own, seeded from the run's seed
and the leaf's path, in calls of up to ``CHUNK`` values over its flat order,
in f32 and then cast to the leaf's type.  So any leaf can be drawn
again, alone, and comes out the same: the program's state can be freed
before the reference runs, and the reference draws what it reads.  The
distribution of a leaf follows its name (``RULES``, the architectures'
usual initialisations).
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, Tuple

import torch

Path = Tuple[str, ...]
CHUNK = 1 << 28


def _fan_in(shape, n, g, dev):
    return torch.randn((n,), generator=g, device=dev) / math.sqrt(shape[-2])


def _normal(std):
    return lambda shape, n, g, dev: torch.randn((n,), generator=g,
                                                device=dev) * std


def _uniform(n, g, dev, lo, hi):
    return torch.rand((n,), generator=g, device=dev) * (hi - lo) + lo


def _dt_bias(shape, n, g, dev):
    # softplus⁻¹ of a step drawn log-uniform in [1e-3, 1e-1]
    dt = torch.exp(_uniform(n, g, dev, math.log(1e-3), math.log(1e-1)))
    return torch.log(torch.expm1(dt))


def _a_log(shape, n, g, dev):
    # decay rates A = -exp(a_log) in [-16, -1]
    return _uniform(n, g, dev, 0.0, math.log(16.0))


def _const(v):
    return lambda shape, n, g, dev: torch.full((n,), v, device=dev)


# Leaf name -> draw(leaf shape, count, generator, device): ``count`` f32
# values of the leaf, in its flat order.  "fan_in" leaves are
# N(0, 1 / shape[-2]): linear weights (d_in, d_out), experts (E, d_in,
# d_out) and the depthwise conv (K, C), whose second-last axis is the one
# each output sums over.
RULES: Dict[str, Callable] = {
    "w": _fan_in, "w_gate": _fan_in, "w_up": _fan_in, "w_down": _fan_in,
    "conv_w": _fan_in,
    "emb": _normal(0.02), "router": _normal(0.02),
    "b": _const(0.0), "conv_b": _const(0.0),
    "g": _const(1.0), "d_skip": _const(1.0),
    "dt_bias": _dt_bias, "a_log": _a_log,
}


def leaves(template) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, stand-in) of every leaf of a nested dict, in key order."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + (k,))
        else:
            yield path, node
    yield from walk(template, ())


def leaf_seed(seed: int, path: Path) -> int:
    digest = hashlib.sha256(f"{seed}/{'/'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class Weights:
    """The leaves of ``template`` drawn from ``seed`` on ``device``."""

    def __init__(self, template, seed: int, device: torch.device):
        self.specs = dict(leaves(template))
        self.seed = seed
        self.device = device
        self._held: Dict[Path, torch.Tensor] = {}

    def draw(self, path: Path) -> torch.Tensor:
        """A fresh copy of the leaf at ``path``."""
        spec = self.specs[path]
        rule = RULES[path[-1]]
        g = torch.Generator(device=self.device)
        g.manual_seed(leaf_seed(self.seed, path))
        out = torch.empty(spec.shape, dtype=spec.dtype, device=self.device)
        flat, shape = out.view(-1), tuple(spec.shape)
        for at in range(0, flat.numel(), CHUNK):
            n = min(CHUNK, flat.numel() - at)
            flat[at:at + n].copy_(rule(shape, n, g, self.device))
        return out

    def get(self, path: Path) -> torch.Tensor:
        """The leaf at ``path``, drawn once and held until ``drop_all``."""
        if path not in self._held:
            self._held[path] = self.draw(path)
        return self._held[path]

    def drop_all(self) -> None:
        self._held.clear()
