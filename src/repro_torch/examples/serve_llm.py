"""Serving example: batched requests against a reduced assigned architecture,
with the paper's optimizations as switches, on the card
(``examples/serve_llm.py``'s counterpart).

  --engine continuous   per-slot continuous batching (serving/continuous.py)
  --quant SINT          int8 weights through the qmatmul kernel (§6.1)
  --kv-quant            int8 KV cache (§6.1 applied to serving state)
  --cyclic N            multipart decode, N layer-segments per cycle (§6.3);
                        with --engine continuous, segments compose with slots

Random weights from a seeded generator on ``--device``; the vlm and audio
families get zero ``image_emb``/``frames`` extras on the device.  The
mamba2 and Jamba prefills run the ``ssd_scan`` kernel on the card.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_llm --arch qwen3_8b \\
          --engine continuous [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import vlm
from repro_torch.models.api import get_model
from repro_torch.serving import ContinuousEngine, CyclicDecoder, Engine, Request

SLOTS, CACHE_LEN, PROMPT_LEN = 4, 128, 8


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_llm")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_8b")
    ap.add_argument("--engine", choices=("wave", "continuous"), default="wave")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", choices=("SINT", "INT", "DINT"))
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--cyclic", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model serves (cuda or cpu)")
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    """The reduced config of ``--arch`` with the switches applied."""
    cfg = get_config(args.arch).reduced()
    if args.quant:
        cfg = cfg.with_(quant=args.quant)
    if args.kv_quant:
        cfg = cfg.with_(kv_quant=True)
    return cfg


def make_extras(cfg, device) -> Dict[str, torch.Tensor]:
    """Zero image embeddings (vlm) or frames (audio), one row per slot."""
    if cfg.family == "vlm":
        return {"image_emb": torch.zeros(
            (SLOTS, cfg.num_image_tokens, vlm.VISION_D), dtype=cfg.dtype,
            device=device)}
    if cfg.family == "audio":
        return {"frames": torch.zeros(
            (SLOTS, cfg.encoder_frames, cfg.d_model), dtype=cfg.dtype,
            device=device)}
    return {}


def serve(args: argparse.Namespace, api, params,
          extras: Dict[str, torch.Tensor]) -> Dict[int, List[int]]:
    """Serve ``args.requests`` seeded 8-token prompts (or, under ``--cyclic``
    with the wave engine, decode request 0 through the §6.3
    :class:`CyclicDecoder`) and print what the reference prints; returns
    each request's tokens by uid."""
    cfg = api.cfg
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    if args.cyclic and args.engine == "wave":
        prompt = rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
        batch = {"tokens": torch.from_numpy(prompt[None]).to(dev),
                 **{k: v[:1] for k, v in extras.items()}}
        cache, logits = api.prefill(params, batch, CACHE_LEN)
        first = torch.argmax(logits[:, -1], dim=-1)
        cd = CyclicDecoder(cfg, params, n_segments=args.cyclic, batch=1,
                           cache_len=CACHE_LEN, backend=api.backend,
                           device=dev)
        toks, _, stats = cd.decode_tokens(cache, first, PROMPT_LEN,
                                          args.max_new,
                                          control_task=lambda: None)
        ct = np.asarray(stats.cycle_times_s) * 1e3
        print(f"multipart decode: {args.cyclic} cycles/token; "
              f"cycle p50={np.percentile(ct, 50):.1f}ms "
              f"p99={np.percentile(ct, 99):.1f}ms")
        print("tokens:", toks)
        return {0: list(toks)}

    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        PROMPT_LEN).astype(np.int32),
                    max_new_tokens=args.max_new, temperature=args.temperature)
            for i in range(args.requests)]
    if args.engine == "continuous":
        engine = ContinuousEngine(api, params, batch_slots=SLOTS,
                                  cache_len=CACHE_LEN,
                                  cyclic_segments=args.cyclic, device=dev)
        done = engine.serve(reqs)
        for c in done:
            print(f"req {c.uid}: prefill {c.prefill_s * 1e3:.0f}ms "
                  f"finished {c.finished_s * 1e3:.0f}ms "
                  f"tokens={c.tokens[:10].tolist()}...")
        st = engine.last_stats
        print(f"continuous{f' x {args.cyclic}-part' if args.cyclic else ''}: "
              f"{st.steps} steps, {st.admitted} requests, "
              f"{st.wall_s:.2f}s wall")
    else:
        engine = Engine(api, params, batch_slots=SLOTS, cache_len=CACHE_LEN,
                        extras=extras, device=dev)
        done = engine.serve(reqs)
        for c in done:
            print(f"req {c.uid}: prefill {c.prefill_s * 1e3:.0f}ms "
                  f"{c.tokens_per_s:.1f} tok/s  "
                  f"tokens={c.tokens[:10].tolist()}...")
    return {c.uid: c.tokens.tolist() for c in done}


def build(args: argparse.Namespace, backend="auto"):
    """The model ``args`` asks for on ``--device`` (``backend`` as
    ``get_model`` takes it), its random params (seed 0) and extras."""
    dev = resolve_device(args.device)
    cfg = config(args)
    api = get_model(cfg, backend=backend)
    params = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    return api, params, make_extras(cfg, dev)


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, List[int]]:
    """Serve as ``argv`` says; returns each request's tokens by uid."""
    args = parse_args(argv)
    api, params, extras = build(args)
    print(f"serving {api.cfg.name} (reduced) quant={api.cfg.quant} "
          f"kv_quant={api.cfg.kv_quant}")
    return serve(args, api, params, extras)


if __name__ == "__main__":
    main()
