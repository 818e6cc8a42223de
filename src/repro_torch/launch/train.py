"""Training launcher (``repro.launch.train``'s counterpart): train any
architecture, reduced or full, on the synthetic LM stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_8b \\
      --reduced --steps 20 --batch 8 --seq 128 [--device cpu]

Random weights from ``--seed``; batches from ``data.SyntheticLM``; the vlm
and audio families get zero ``image_emb``/``frames``, as the reference's
launcher gives them.  Eager AdamW steps (``launch.steps``) on the card
unless ``--device cpu``; ``--ckpt-dir`` saves ``{"params": ...}`` every
``--ckpt-every`` steps (``checkpoint``).

Under ``torch.distributed.run`` (torchrun sets ``RANK`` and
``WORLD_SIZE``) every rank joins one process group (NCCL with one rank per
card where there are enough cards, gloo otherwise) and the launcher trains
with the sharded step (``steps.make_sharded_train_step``) on
``launch.mesh.make_host_mesh()``, the reference's default, or on the
``(16, 16)`` ``make_production_mesh()`` with ``--production-mesh``, which
raises its own ``RuntimeError`` on fewer than 256 ranks.  Every rank makes
the same params and batches from the seed and keeps its shards; a rank
outside the mesh trains nothing; rank 0 prints.  Without a group (a plain
``python -m``) the launcher runs the unsharded step, the reference's
``(1, 1)`` host-mesh step.

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node=1 \
      -m repro_torch.launch.train --arch qwen3_8b --reduced --steps 5
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import save
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     route_gloo_cuda_collectives)
from repro_torch.launch.steps import (make_optimizer, make_sharded_train_step,
                                      make_train_step)
from repro_torch.models import vlm
from repro_torch.models.api import get_model


def _join_torchrun(device: str) -> bool:
    """Join the process group of a ``torch.distributed.run`` launch (and
    take this rank's card); returns whether this call created the group."""
    if dist.is_initialized() or "RANK" not in os.environ \
            or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    backend = ("nccl" if cuda and torch.cuda.device_count() >= world
               else "gloo")
    dist.init_process_group(backend)
    if backend == "gloo" and cuda:
        route_gloo_cuda_collectives()
    return True


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    created = _join_torchrun(args.device)
    try:
        _train(args)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> None:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)

    mesh = None
    if args.production_mesh or dist.is_initialized():
        mesh = (make_production_mesh(device_type=dev.type)
                if args.production_mesh else
                make_host_mesh(device_type=dev.type))
        if mesh.get_coordinate() is None:
            return
    log = mesh is None or dist.get_rank() == 0

    params = api.init(torch.Generator(device=dev).manual_seed(args.seed),
                      device=dev)
    opt_init, opt_update = make_optimizer(args.lr, args.warmup, args.steps)
    if mesh is None:
        step_fn = make_train_step(api, opt_update)
    else:
        params = sh.shard_params(params, cfg, mesh)
        step_fn = make_sharded_train_step(api, opt_update, mesh)
    opt_state = opt_init(params)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    stream = data.batches()

    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        host_batch = next(stream)
        batch = {k: torch.from_numpy(v).to(dev, dtype=torch.int64)
                 for k, v in host_batch.items()}
        if cfg.family == "vlm":
            b, s = batch["tokens"].shape
            text = max(s - cfg.num_image_tokens, 1)
            batch = {
                "tokens": batch["tokens"][:, :text],
                "labels": batch["labels"][:, :text],
                "image_emb": torch.zeros((b, cfg.num_image_tokens,
                                          vlm.VISION_D), dtype=cfg.dtype,
                                         device=dev),
            }
        elif cfg.family == "audio":
            b = batch["tokens"].shape[0]
            batch["frames"] = torch.zeros(
                (b, cfg.encoder_frames, cfg.d_model), dtype=cfg.dtype,
                device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if log and (step % args.log_every == 0 or step == args.steps - 1):
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt / (step + 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, step + 1, {"params": params})

    if log:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"{(time.time() - t0):.1f}s total")


if __name__ == "__main__":
    main()
