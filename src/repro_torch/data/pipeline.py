"""Data pipeline (``repro.data.pipeline``'s counterpart): a seeded
synthetic token stream for LM training, the ARRBIN binary shards and a
round-robin shard reader.

The batches are the reference's, byte for byte: the same numpy generators
drawn in the same order.  They stay host numpy ``int32``; a caller moves
them to the card as the port's ``int64`` token layout
(``models.api.ModelAPI.batch_specs``), which ``torch.gather`` needs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence

import numpy as np

from repro_torch.core.porting import arrbin, binarr


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    markov_order: int = 1
    markov_weight: float = 0.7   # P(next = f(prev)) — learnable structure


class SyntheticLM:
    """Seeded synthetic LM stream: a mixture of a Zipfian unigram draw and a
    fixed per-token successor, so a model can bring the loss below the
    unigram entropy."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        # fixed random successor table: the learnable structure
        table_rng = np.random.default_rng(cfg.seed + 1)
        self._succ = table_rng.integers(0, cfg.vocab, size=cfg.vocab)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._unigram = probs / probs.sum()

    def _sample_row(self, length: int) -> np.ndarray:
        out = np.empty(length + 1, np.int32)
        out[0] = self._rng.choice(self.cfg.vocab, p=self._unigram)
        use_succ = self._rng.random(length) < self.cfg.markov_weight
        fresh = self._rng.choice(self.cfg.vocab, size=length, p=self._unigram)
        for i in range(length):
            out[i + 1] = self._succ[out[i]] if use_succ[i] else fresh[i]
        return out

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        b, s = self.cfg.global_batch, self.cfg.seq_len
        while True:
            rows = np.stack([self._sample_row(s) for _ in range(b)])
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


# ---------------------------------------------------------------------------
# Binary shard format (ARRBIN layout + sidecar metadata, §4.3 style)
# ---------------------------------------------------------------------------


def write_shard(path: str, tokens: np.ndarray) -> None:
    arrbin(path, tokens.astype(np.int32))
    with open(path + ".meta", "w") as f:
        f.write(f"int32 {tokens.shape[0]} {tokens.shape[1]}\n")


def read_shard(path: str) -> np.ndarray:
    with open(path + ".meta") as f:
        dtype, rows, cols = f.read().split()
    return binarr(path, dtype, (int(rows), int(cols)))


class ShardedDataset:
    """Round-robin reader over binary shards (deterministic, restartable)."""

    def __init__(self, paths: Sequence[str], global_batch: int):
        if not paths:
            raise ValueError("no shards")
        self.paths = list(paths)
        self.global_batch = global_batch

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            shard = read_shard(self.paths[step % len(self.paths)])
            n = shard.shape[0]
            idx = (np.arange(self.global_batch) + step * self.global_batch) % n
            rows = shard[idx]
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
            step += 1
