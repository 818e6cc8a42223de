"""End-to-end driver: train a ~55M-parameter qwen3-family model for a few
hundred steps on the synthetic LM stream, on the card
(``examples/train_llm.py``'s counterpart).

Defaults: 12 layers x d_model 512 x 8 heads with the qwen3 feature set
(qk-norm, GQA, SwiGLU) and tied embeddings over a 32k vocab ≈ 55M params;
use --big for the ~110M variant.  Random weights from a seeded generator on
``--device``; batches from ``data.SyntheticLM``; eager AdamW steps
(``launch.steps.make_train_step``, which updates params and moments in
place, as the reference donates them).  ``--ckpt-dir`` saves
``{"params": ...}`` in the reference's on-disk format (``checkpoint.save``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_llm [--steps 300] \\
          [--big] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.checkpoint import save
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import leaves

LR, WARMUP = 6e-4, 50


def small_config(big: bool = False):
    """The example's qwen3-family model: ~55M params, or ~110M with
    ``big``."""
    return get_config("qwen3_8b").with_(
        n_layers=16 if big else 12,
        d_model=768 if big else 512,
        n_heads=12 if big else 8,
        n_kv_heads=4,
        d_ff=2048 if big else 1408,
        vocab=32768,
    )


@dataclasses.dataclass
class TrainRun:
    """A finished run: the trained params and optimizer state, each step's
    loss and gradient norm, and each step's wall seconds (the host's read
    of the loss included)."""

    params: dict
    opt: object
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]


def train(cfg, *, steps: int, batch: int, seq: int,
          device="cuda") -> TrainRun:
    """Train ``cfg`` from random weights (seed 0) for ``steps`` steps of
    ``batch`` x ``seq`` tokens at :data:`LR` after :data:`WARMUP` steps;
    prints the loss and tokens/s every 20 steps and at the last."""
    dev = resolve_device(device)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"model: {cfg.n_layers}L d{cfg.d_model} -> {n_params/1e6:.1f}M params")

    opt_init, opt_update = make_optimizer(lr=LR, warmup=WARMUP, steps=steps)
    opt = opt_init(params)
    step = make_train_step(api, opt_update)
    stream = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0)).batches()

    losses, norms, secs = [], [], []
    t0 = time.time()
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev, dtype=torch.int64)
             for k, v in next(stream).items()}
        s0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - s0)
        norms.append(float(m["grad_norm"]))
        if i % 20 == 0 or i == steps - 1:
            tok_s = batch * seq * (i + 1) / (time.time() - t0)
            print(f"step {i:4d}  loss {losses[-1]:.4f}  {tok_s:,.0f} tok/s")
    return TrainRun(params, opt, losses, norms, secs)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_llm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    run = train(small_config(args.big), steps=args.steps, batch=args.batch,
                seq=args.seq, device=args.device)
    print(f"\nloss {run.losses[0]:.3f} -> {run.losses[-1]:.3f} over "
          f"{args.steps} steps")
    if args.ckpt_dir:
        path = save(args.ckpt_dir, args.steps, {"params": run.params})
        print("checkpoint:", path)


if __name__ == "__main__":
    main()
