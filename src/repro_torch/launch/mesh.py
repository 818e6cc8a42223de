"""Fleet and production meshes over a ``torch.distributed`` process group
(``repro.launch.mesh``'s counterpart).

The reference is single-controller: one process owns every device and a
``jax.sharding.Mesh`` names them.  The port is SPMD: one process per rank,
joined in a default process group, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` over those ranks with the
reference's axis names (``"data"``, ``"model"``, ``"pod"``).  Every mesh
function here needs the default group to exist: launch the ranks with
``python -m torch.distributed.run --nproc-per-node=<n> ...`` (torchrun),
which sets the environment ``init_process_group`` reads, or with
:func:`spawn`.  Building a mesh is collective: every rank of the default
group calls it, also the ranks it leaves out (a mesh takes a prefix of the
world, as the reference's takes a prefix of the device list; a rank outside
it has no coordinate).

Backends are the caller's choice and are never switched after a failure:
``"nccl"`` puts one rank on each card; ``"gloo"`` serves CPU ranks, or ranks
that share a card (it moves CUDA tensors through the host).  NCCL refuses two
ranks on one device.

The reference's roofline constants (``PEAK_BF16_FLOPS``, ``HBM_BW``, ...)
are a TPU v5e's and are not carried over: the port states no TPU number.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

LAUNCH_HINT = ("launch the ranks with `python -m torch.distributed.run "
               "--nproc-per-node=<n> ...` or "
               "repro_torch.launch.mesh.spawn(fn, world_size=<n>, ...)")


def _world() -> int:
    """Ranks in the default process group; raises when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group "
            f"(world size 1 included); {LAUNCH_HINT}")
    return dist.get_world_size()


def _mesh(device_type: str, shape: Tuple[int, ...],
          axes: Tuple[str, ...]) -> DeviceMesh:
    return DeviceMesh(device_type, torch.arange(math.prod(shape))
                      .reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's pod mesh: ``(16, 16)`` over ``("data", "model")``,
    or ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {have} present; "
            f"{LAUNCH_HINT}")
    return _mesh(device_type, shape, axes)


def make_host_mesh(*, device_type: str = "cuda") -> DeviceMesh:
    """A ``(1, 1)`` mesh over rank 0 with axes ``("data", "model")``."""
    _world()
    return _mesh(device_type, (1, 1), ("data", "model"))


def make_fleet_mesh(n_devices: int | None = None, *, model_shards: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """The fleet-serving mesh: 1-D ``("data",)``, or 2-D ``("data",
    "model")`` when ``model_shards > 1``, over the first ``n_devices x
    model_shards`` ranks of the default group.

    ``n_devices`` is the data-axis width; it defaults to every rank (divided
    by ``model_shards`` for a 2-D mesh).  ``device_type`` is the device the
    ranks serve on: ``"cuda"`` (each rank's current card) or ``"cpu"``.
    """
    have = _world()
    if model_shards < 1:
        raise RuntimeError(f"model_shards must be >= 1, got {model_shards}")
    if model_shards == 1:
        n = have if n_devices is None else n_devices
        if not 1 <= n <= have:
            raise RuntimeError(
                f"fleet mesh needs 1..{have} ranks, asked for {n}; "
                f"{LAUNCH_HINT}")
        return _mesh(device_type, (n,), ("data",))
    n_data = have // model_shards if n_devices is None else n_devices
    need = n_data * model_shards
    if n_data < 1 or need > have:
        raise RuntimeError(
            f"fleet mesh ({n_data}, {model_shards}) needs {need} ranks but "
            f"only {have} present; {LAUNCH_HINT}")
    return _mesh(device_type, (n_data, model_shards), ("data", "model"))


def data_axes(mesh: Any) -> Tuple[str, ...]:
    """The batch-parallel axes of a mesh, or of an ``{axis: size}``
    mapping ('pod' folds into data)."""
    names = getattr(mesh, "mesh_dim_names", None) or tuple(mesh)
    return ("pod", "data") if "pod" in names else ("data",)


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_method: str, args: tuple, results) -> None:
    # One rank per card where there are enough cards; ranks beyond the
    # card count share them (gloo), and NCCL refuses a shared card itself.
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        results.put((rank, fn(rank, world, *args)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, *args: Any,
          timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    joined in one process group, and return each rank's result in rank
    order.

    The processes start with the spawn method (never fork, so a parent that
    has CUDA up stays safe) and meet at a ``file://`` rendezvous in a fresh
    temporary directory, so concurrent callers never collide.  With CUDA,
    rank ``r`` runs on card ``r % device_count``.  ``fn`` must be importable
    by name (a module-level function) and its results picklable.  If any
    rank raises, the others are ended and this raises with its traceback;
    so does a run longer than ``timeout`` seconds.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, backend, init, args, results),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while True:
                # Drain before joining: a rank blocks on a full pipe until
                # its result is read.
                while not results.empty():
                    rank, value = results.get()
                    got[rank] = value
                if procs.join(timeout=0.05):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} still running "
                        f"after {timeout} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
    while not results.empty():
        rank, value = results.get()
        got[rank] = value
    missing = sorted(set(range(world_size)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} of {fn.__name__} returned no "
                           "result")
    return [got[r] for r in range(world_size)]
