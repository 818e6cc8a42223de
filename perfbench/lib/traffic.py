"""The one traffic generator: requests from a mix's parameters and a seed.

A mix's file (``perfbench/workloads/<cell>.json``) gives, under
``traffic``, how many requests one engine call takes (``backlog``) and the
length of their prompts and outputs, each as

  {"fixed": n}                       every request n
  {"uniform": [lo, hi]}              ``LEVELS`` levels evenly spaced
  {"log_uniform": [lo, hi]}          ``LEVELS`` levels spaced by ratio

The levels are the midpoints of ``LEVELS`` equal-probability bins of the
named distribution; a call carries each level ``backlog / LEVELS`` times,
in one order and one pairing of prompt and output lengths, the same for
every call and every seed: which lengths come last decides how long an
engine call drains, so an order drawn from the run's seed would change
its work.  The run's seed
draws the token ids (uniform over the vocabulary).  Every request decodes
greedily and stops at its output length (no end-of-sequence token).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

LEVELS = 16

@dataclasses.dataclass
class Req:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int


def levels(spec: Dict) -> List[int]:
    """The lengths a spec draws from, one per level."""
    if "fixed" in spec:
        return [int(spec["fixed"])]
    qs = [(i + 0.5) / LEVELS for i in range(LEVELS)]
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return [int(round(lo + q * (hi - lo))) for q in qs]
    lo, hi = spec["log_uniform"]
    return [int(round(lo * (hi / lo) ** q)) for q in qs]


def _column(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths, each level equally often, in ``rng``'s order."""
    lv = levels(spec)
    if n % len(lv):
        raise ValueError(f"a backlog of {n} does not hold each of "
                         f"{len(lv)} levels equally often")
    return rng.permutation(np.repeat(lv, n // len(lv)))


class Generator:
    """Successive engine calls' requests for one mix and seed."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.traffic = traffic
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.uid = 0

    def batch(self, n: Optional[int] = None) -> List[Req]:
        """The next call's ``backlog`` requests (or ``n``: each level
        ``n / LEVELS`` times)."""
        n = int(self.traffic["backlog"]) if n is None else n
        order = np.random.default_rng(0)
        prompts = _column(self.traffic["prompt_len"], n, order)
        outs = _column(self.traffic["new_tokens"], n, order)
        reqs = []
        for p, o in zip(prompts, outs):
            reqs.append(Req(uid=self.uid, max_new_tokens=int(o),
                            prompt=self.rng.integers(0, self.vocab, int(p))))
            self.uid += 1
        return reqs

    def warm_up(self) -> List[Req]:
        """One request of each prompt length the mix uses, with the
        shortest output length: every prefill shape a call will take."""
        outs = min(levels(self.traffic["new_tokens"]))
        reqs = []
        for p in levels(self.traffic["prompt_len"]):
            reqs.append(Req(uid=self.uid, max_new_tokens=max(outs, 2),
                            prompt=self.rng.integers(0, self.vocab, p)))
            self.uid += 1
        return reqs

