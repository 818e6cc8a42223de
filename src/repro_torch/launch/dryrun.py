"""Production-mesh dry run (``repro.launch.dryrun``'s counterpart): trace
every (architecture x input shape) step on the ``(16, 16)`` or
``(2, 16, 16)`` mesh without a device or a byte of tensor memory, and record
what each rank would hold, send and compute.

For each case this:

1. joins a ``"fake"`` process group of 256 (or 512) ranks as rank 0
   (``torch.testing``'s ``FakeStore``: collectives return at once) and
   builds ``launch.mesh.make_production_mesh`` over it on ``"cpu"``;
2. makes the params (``api.init`` under ``FakeTensorMode``), optimizer
   state, batch and cache as ``meta`` tensors (shapes and dtypes only),
   laid out on the mesh by ``launch.shardings`` as DTensors (a fake mode
   around the step itself breaks DTensor's strided shards);
3. runs the train, prefill or decode step once (``launch.steps``; the
   activation hook installed), under ``CommDebugMode`` and a FLOP counter;
   the prefill's and decode's caches are laid out by ``cache_shardings``
   after the step, as the reference's ``out_shardings`` do;
4. writes a JSON blob per case under ``experiments/dryrun_torch/``.

Success proves what the reference's ``.lower().compile()`` proves for the
shardings: every op of the step has a sharding rule on the mesh and every
sharded dim divides.  The tensors are on no device, so the step takes the
kernels' plain versions (``kernels.ops`` launches only on CUDA tensors),
the chunked SSD included; that is a host tool's trace, as the reference's
is a 512-device forced host platform's, not a CPU fallback of the port.

Each blob has the reference's keys.  ``param_bytes``, ``opt_bytes`` and
``cache_bytes`` are the whole trees' bytes; ``per_rank`` holds rank 0's
bytes of params, optimizer state, batch and cache from its local shard
shapes (and ``per_rank_leaves``, each param and cache leaf's); ``hlo_flops``
is the FLOPs one rank computes: each op's FLOPs (``torch.utils.flop_counter``'s
formulas at the global shapes) divided by the ranks that split it (those
whose mesh dims shard or leave pending the op's output), ops inside a
``local_map`` counted at their local shapes; ``collectives["counts"]``
counts the collectives one rank issues, by the reference's type names.
Keys with no counterpart are ``null``: XLA's ``hlo_bytes`` and
``cost_analysis``, ``memory_analysis``'s temp and generated-code bytes
(eager PyTorch has no compiled program whose buffers could be analysed),
the collectives' bytes (``CommDebugMode`` counts operations, not their
sizes) and the lower/compile seconds (``trace_s`` is the fake run's wall
time).  The reference's ``--unroll`` and ``--costs`` are left out: they
work around XLA counting a layer scan's body once, and the port runs its
layers as a Python loop, so every layer is counted.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--both-meshes] [--quant SINT]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, ArchConfig, \
    get_config
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_optimizer,
                                      make_prefill, make_sharded_train_step)
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# torch's collective ops by the reference's HLO names.
_COLLECTIVES = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
                "all_gather": "all-gather", "allgather": "all-gather",
                "reduce_scatter": "reduce-scatter",
                "all_to_all": "all-to-all", "alltoall": "all-to-all",
                "broadcast": "broadcast"}


def _collective_type(op: Any) -> str:
    name = str(op).split(".")[-1].rstrip("_")
    for key, kind in _COLLECTIVES.items():
        if name.startswith(key):
            return kind
    return name


class RankFlops(TorchDispatchMode):
    """Counts the FLOPs one rank computes (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            flops = count(*args, **kwargs, out_val=out)
            first = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(first, DTensor):
                mesh = first.device_mesh
                flops //= math.prod(
                    mesh.size(i) for i, pl in enumerate(first.placements)
                    if pl.is_shard() or pl.is_partial())
            self.flops += flops
        return out


def _bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _local_bytes(tree: Any) -> int:
    return sum(_local(t).numel() * t.element_size() for t in leaves(tree))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _leaf_bytes(tree: Any) -> Dict[str, int]:
    return {path: _local(t).numel() * t.element_size()
            for path, t in sh._paths(tree)}


def effective_config(arch: str, shape: str, quant: Optional[str] = None,
                     n_layers: Optional[int] = None) -> ArchConfig:
    """The reference's ``effective_config`` without ``unroll``: the full
    config, with the SWA variant substituted for full-attention families
    at ``long_500k`` decode, and ``quant``."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    shp = INPUT_SHAPES[shape]
    if shape == "long_500k" and shp["kind"] == "decode" and cfg.family in (
            "dense", "moe", "vlm", "audio") and cfg.sliding_window is None:
        cfg = cfg.with_(sliding_window=cfg.swa_for_long,
                        notes=cfg.notes + " [long_500k: SWA substituted]")
    if quant:
        cfg = cfg.with_(quant=quant)
    return cfg


@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` default process group of ``size`` ranks, this process
    rank 0, for the length of the block (one already there is replaced
    and not restored: a dry run owns its process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_like(tree: Any) -> Any:
    """``meta`` tensors shaped as the tensors of ``tree``."""
    return sh._map_paths(lambda _, t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), tree)


def param_specs(api) -> Any:
    """The param tree of ``api.init`` as ``meta`` tensors: the init runs
    under a ``FakeTensorMode``, which draws nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = api.init(torch.Generator(), device="cpu")
    return _meta_like(fake)


def build_case(arch: str, shape: str, mesh, quant: Optional[str] = None,
               n_layers: Optional[int] = None):
    """``(step, args, meta)`` of one case, its arguments ``meta`` tensors
    laid out on ``mesh``."""
    cfg = effective_config(arch, shape, quant, n_layers)
    api = get_model(cfg)
    shp = INPUT_SHAPES[shape]
    batch, seq, kind = shp["global_batch"], shp["seq_len"], shp["kind"]

    params = param_specs(api)
    meta = {"arch": arch, "shape": shape, "kind": kind,
            "global_batch": batch, "seq_len": seq,
            "n_layers": cfg.n_layers, "param_bytes": _bytes(params),
            "quant": quant}
    params = sh.shard_params(params, cfg, mesh)
    b_specs = api.batch_specs(kind, batch, seq)
    b = sh.place(b_specs,
                 sh.batch_shardings(b_specs, mesh, batch_size=batch), mesh)
    hook = dict(batch_sharded=(kind != "decode" or batch > 1),
                seq_parallel=cfg.seq_parallel)

    if kind == "train":
        opt_init, opt_update = make_optimizer()
        opt = opt_init(params)
        meta["opt_bytes"] = _bytes(opt.mu) + _bytes(opt.nu) + \
            opt.step.numel() * opt.step.element_size()
        train = make_sharded_train_step(api, opt_update, mesh)
        return train, (params, opt, b), meta

    c_specs = api.cache_specs(batch, seq)
    c_shard = sh.cache_shardings(c_specs, cfg, mesh, batch_size=batch)
    meta["cache_bytes"] = _bytes(c_specs)

    def laid_out(cache):
        return sh._map_paths(
            lambda path, t: t.redistribute(
                mesh, sh.to_placements(dict(sh._paths(c_shard))[path], mesh))
            if isinstance(t, DTensor) else t, cache)

    if kind == "prefill":
        prefill = make_prefill(api, cache_len=seq)

        def step(p, bb):
            with sh.hooked(mesh, **hook):
                cache, logits = prefill(p, bb)
            return laid_out(cache), logits

        return step, (params, b), meta
    decode = make_decode_step(api)
    cache = sh.place(c_specs, c_shard, mesh)

    def step(p, c, bb):
        with sh.hooked(mesh, **hook):
            c, logits = decode(p, c, bb, seq - 1)
        return laid_out(c), logits

    return step, (params, cache, b), meta


def run_case(arch: str, shape: str, *, multi_pod: bool = False,
             quant: Optional[str] = None, save: bool = True,
             n_layers: Optional[int] = None) -> Dict[str, Any]:
    """One case on a fake group of the production mesh's size; returns its
    blob (module docstring) and writes it under ``experiments/dryrun_torch``
    when ``save``."""
    from torch.distributed.tensor.debug import CommDebugMode

    n_ranks = 512 if multi_pod else 256
    with fake_world(n_ranks):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        step, args, meta = build_case(arch, shape, mesh, quant, n_layers)
        per_rank = {"params": _local_bytes(args[0])}
        if meta["kind"] == "train":
            opt = args[1]
            per_rank["opt"] = (_local_bytes(opt.mu) + _local_bytes(opt.nu)
                               + opt.step.numel() * opt.step.element_size())
        if meta["kind"] == "decode":
            per_rank["cache_in"] = _local_bytes(args[1])
        per_rank["batch"] = _local_bytes(args[-1])
        leaf_bytes = {"params": _leaf_bytes(args[0])}
        t0 = time.perf_counter()
        with CommDebugMode() as comm, RankFlops() as flops:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        if meta["kind"] == "train":
            out_bytes = per_rank["params"] + per_rank["opt"]
        else:
            per_rank["cache"] = _local_bytes(out[0])
            leaf_bytes["cache"] = _leaf_bytes(out[0])
            out_bytes = per_rank["cache"] + _local(out[1]).numel() \
                * out[1].element_size()
    counts: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _collective_type(op)
        counts[kind] = counts.get(kind, 0) + n
    result = {
        **meta, "variant": None, "unrolled": None,
        "mesh": "2x16x16" if multi_pod else "16x16", "n_chips": n_ranks,
        "per_rank": per_rank, "per_rank_leaves": leaf_bytes,
        "hlo_flops": float(flops.flops), "hlo_bytes": None,
        "cost_analysis": None,
        "memory_analysis": {
            "argument_bytes": sum(v for k, v in per_rank.items()
                                  if k != "cache"),
            "output_bytes": out_bytes,
            "temp_bytes": None, "generated_code_bytes": None},
        "collectives": {"bytes_by_type": None, "counts": counts,
                        "wire_bytes": None},
        "lower_s": None, "compile_s": None, "trace_s": trace_s,
    }
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        fname = f"{arch}__{shape}__{result['mesh']}"
        if quant:
            fname += f"__{quant}"
        with open(os.path.join(OUT_DIR, fname + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", choices=("SINT", "INT", "DINT"))
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cases = [(a, s, m) for a in archs for s in shapes for m in meshes]

    failures = 0
    for a, s, m in cases:
        tag = f"{a:24s} {s:12s} {'2x16x16' if m else '16x16 '}"
        try:
            r = run_case(a, s, multi_pod=m, quant=args.quant)
            print(f"OK   {tag} flops/rank={r['hlo_flops']:.3e} "
                  f"params/rank={r['per_rank']['params']:.3e}B "
                  f"collectives={r['collectives']['counts']} "
                  f"trace={r['trace_s']:.1f}s", flush=True)
        except Exception as e:              # report the case, go on
            failures += 1
            print(f"FAIL {tag} {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures}/{len(cases)} dry-run cases failed")
    print(f"all {len(cases)} dry-run cases traced")


if __name__ == "__main__":
    main()
