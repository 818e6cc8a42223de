"""Serving launcher: batched requests against a ported architecture
(``repro.launch.serve``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
      --quant SINT [--cyclic 4] [--engine continuous] [--reduced] \\
      [--device cpu]

Random weights from ``--seed``.  ``--quant`` serves with the paper's
int8/int16/int32 quantized linears (§6.1; SINT through the ``qmatmul``
kernel); ``--cyclic N`` decodes multipart, N layer segments per token
(§6.3): with the wave engine, request 0 alone through a
:class:`~repro_torch.serving.CyclicDecoder` (dense, moe, vlm and ssm; the
others serve through the wave engine, as the reference), with ``--engine
continuous`` every slot's step.  The vlm and audio families get zero
``image_emb``/``frames`` extras, one row per slot.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import vlm
from repro_torch.models.api import get_model
from repro_torch.serving import (ContinuousEngine, CyclicDecoder, Engine,
                                 Request)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", choices=("SINT", "INT", "DINT"))
    ap.add_argument("--cyclic", type=int, default=0,
                    help="decode multipart with N segments per token")
    ap.add_argument("--engine", choices=("wave", "continuous"),
                    default="wave")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant:
        cfg = cfg.with_(quant=args.quant)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed),
                      device=dev)

    extras = {}
    if cfg.family == "vlm":
        extras["image_emb"] = torch.zeros(
            (args.batch_slots, cfg.num_image_tokens, vlm.VISION_D),
            dtype=cfg.dtype, device=dev)
    elif cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (args.batch_slots, cfg.encoder_frames, cfg.d_model),
            dtype=cfg.dtype, device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]

    if (args.cyclic and args.engine == "wave"
            and cfg.family in ("dense", "moe", "vlm", "ssm")):
        batch = {"tokens": torch.from_numpy(reqs[0].prompt[None]).to(dev),
                 **{k: v[:1] for k, v in extras.items()}}
        cache, logits = api.prefill(params, batch, args.cache_len)
        first = torch.argmax(logits[:, -1], dim=-1)
        cd = CyclicDecoder(cfg, params, n_segments=args.cyclic, batch=1,
                           cache_len=args.cache_len, device=dev)
        t0 = time.perf_counter()
        toks, _, stats = cd.decode_tokens(cache, first, args.prompt_len,
                                          args.max_new)
        dt = time.perf_counter() - t0
        ct = np.asarray(stats.cycle_times_s)
        print(f"cyclic decode: {len(toks)} tokens in {dt:.2f}s, "
              f"{stats.cycles_per_token} cycles/token, "
              f"cycle p50={np.percentile(ct, 50) * 1e3:.1f}ms "
              f"p99={np.percentile(ct, 99) * 1e3:.1f}ms")
        print("tokens:", toks)
        return

    if args.engine == "continuous":
        engine = ContinuousEngine(api, params, batch_slots=args.batch_slots,
                                  cache_len=args.cache_len, seed=args.seed,
                                  cyclic_segments=args.cyclic, device=dev)
    else:
        engine = Engine(api, params, batch_slots=args.batch_slots,
                        cache_len=args.cache_len, extras=extras,
                        seed=args.seed, device=dev)
    done = engine.serve(reqs)
    for c in done:
        print(f"req {c.uid}: prefill {c.prefill_s * 1e3:.1f}ms, "
              f"{c.tokens_per_s:.1f} tok/s -> {c.tokens[:16].tolist()}...")
    if args.engine == "continuous":
        print(f"serve stats: {engine.last_stats}")


if __name__ == "__main__":
    main()
