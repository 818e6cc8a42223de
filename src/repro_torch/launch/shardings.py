"""Sharding rules: parameter, optimizer, batch, cache and activation layouts
(``repro.launch.shardings``'s counterpart).

The scheme is the reference's:

* **params**: tensor parallel on ``"model"``.  q/k/v, gate/up and in
  projections shard their output dim, o/down and out projections their
  input dim, embeddings the vocab dim; MoE experts shard the expert dim when
  the axis divides it (else the FFN hidden dim); norms and scales
  replicate.  The stacked leading layer axes are never sharded.
* **optimizer state** mirrors the params (ZeRO-style); scalars replicate.
* **batch**: the leading dim on ``("pod", "data")`` / ``("data",)``.
* **KV caches**: context parallel, the sequence axis on ``"model"`` and the
  batch on ``"data"`` (both axes on the sequence when the batch cannot use
  ``"data"``); SSM state: heads on ``"model"``.
* **activations**: batch-sharded between blocks (``"btd"``, with sequence
  parallelism on request); MoE expert inputs expert-sharded
  (``"expert_in"``).

A spec is the port's own: a tuple with one entry per tensor dim, each
``None`` (replicated), a mesh axis name, or a tuple of axis names, the
reference's ``PartitionSpec`` read as a tuple.  The rules take the mesh as a
``DeviceMesh`` or as a ``{axis: size}`` mapping and read only its axis
sizes.  :func:`to_placements` turns a spec into the DTensor placements of a
mesh; :func:`install_hook` makes the models' ``common.constrain`` lay
DTensor activations out as the reference constrains its activations.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import data_axes
from repro_torch.models import common as cm
from repro_torch.optim.adamw import OptState

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, or of a mapping given as one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _size(sizes: Dict[str, int], ax: Axis) -> int:
    axes = ax if isinstance(ax, tuple) else (ax,)
    return int(np.prod([sizes[a] for a in axes]))


def param_spec(path: str, shape: Tuple[int, ...], cfg: ArchConfig,
               mesh: Any) -> Spec:
    """The spec of one parameter leaf (``path`` is its '/'-joined keys)."""
    sizes = axis_sizes(mesh)
    rank = len(shape)
    parts = path.split("/")
    stacked = any(p.endswith("blocks") for p in parts)
    # leading stacked axes: blocks/L, and Jamba's sub-stacks one more
    lead = 0
    if stacked:
        lead = 1
        if cfg.family == "hybrid" and any(
                k in path for k in ("mamba/", "mlp/", "moe/")):
            lead = 2

    def pad(tail: Tuple) -> Spec:
        return (None,) * lead + tuple(tail)

    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    if name == "emb":
        return ("model", None)

    # MoE experts (E, d, f) / (E, f, d); the router replicates
    if parent == "ffn" or "/moe/" in path or path.endswith("router"):
        if name == "router":
            return pad((None, None))
        if name in ("w_gate", "w_up", "w_down") and rank - lead == 3:
            if shape[lead] % sizes["model"] == 0:
                return pad(("model", None, None))
            # expert count not divisible: shard the FFN hidden dim instead
            if name == "w_down":
                return pad((None, "model", None))
            return pad((None, None, "model"))

    out_sharded = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "fc1")
    in_sharded = ("wo", "w_down", "out_proj", "fc2")
    if name in ("w", "qw"):
        if parent in out_sharded:
            return pad((None, "model"))
        if parent in in_sharded:
            return pad(("model", None))
    if name == "w_scale":
        return pad(("model",) if parent in out_sharded else (None,))
    if name == "b":
        if parent in out_sharded and rank - lead == 1:
            return pad(("model",))
        return pad((None,) * (rank - lead))

    # the Mamba conv and scalars, norms, everything else: replicated
    return (None,) * rank


def sanitize(spec: Spec, shape: Tuple[int, ...], mesh: Any) -> Spec:
    """Drop mesh axes from the dims they do not divide (vocab 50280 on a
    16-way axis, say): replicating an odd-sized dim is cheaper than padding
    it.  A one-axis tuple reads as that axis, as in a ``PartitionSpec``."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(None if ax is None or shape[d] % _size(sizes, ax) else
                 ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for d, ax in enumerate(spec))


def _paths(tree: Any, prefix: str = ""):
    """(path, leaf) for every leaf of nested dicts and lists, paths as
    '/'-joined keys and indices (the reference's pytree paths).  A tuple is
    a leaf: specs are tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map_paths(fn: Callable[[str, Any], Any], tree: Any,
               prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_shardings(params: Any, cfg: ArchConfig, mesh: Any) -> Any:
    """The sanitized spec of every leaf of a param tree (tensors, meta
    tensors included, or anything with a ``shape``), in its structure."""
    return _map_paths(
        lambda path, leaf: sanitize(
            param_spec(path, tuple(leaf.shape), cfg, mesh),
            tuple(leaf.shape), mesh), params)


def opt_shardings(opt: OptState, p_specs: Any, mesh: Any) -> OptState:
    """The optimizer state mirrors the params; the step and the 0-d moments
    of integer leaves replicate."""
    flat = dict(_paths(p_specs))

    def match(moments):
        return _map_paths(lambda path, m: flat[path] if m.ndim > 0 else (),
                          moments)

    return OptState(step=(), mu=match(opt.mu), nu=match(opt.nu))


def batch_shardings(batch: Dict[str, Any], mesh: Any, *,
                    batch_size: int) -> Dict[str, Spec]:
    """The leading (batch) dim of every batch leaf on the data axes, when
    they divide ``batch_size``; ``"data"`` alone, or replicated, else."""
    sizes = axis_sizes(mesh)
    dp = data_axes(sizes)
    lead = dp if batch_size % _size(sizes, dp) == 0 else (
        ("data",) if batch_size % sizes["data"] == 0 else None)
    return {k: sanitize((lead,) + (None,) * (len(s.shape) - 1),
                        tuple(s.shape), mesh)
            for k, s in batch.items()}


def cache_shardings(cache: Any, cfg: ArchConfig, mesh: Any, *,
                    batch_size: int) -> Any:
    """The decode cache's layout (context parallel; module docstring)."""
    sizes = axis_sizes(mesh)
    data_ok = batch_size % sizes["data"] == 0
    b_ax = "data" if data_ok else None
    # the sequence axis: "model" always; fold "data" in when the batch
    # cannot use it
    s_ax = "model" if data_ok else ("data", "model")

    def spec_for(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if name.endswith("ssm"):         # (L, [n_mamba,] B, H, P, N)
            spec = (None,) * (len(shape) - 4) + (b_ax, "model", None, None)
        elif name.endswith("conv"):      # (L, [n_mamba,] B, K-1, C)
            spec = (None,) * (len(shape) - 3) + (b_ax, None, "model")
        elif name.endswith(("xk", "xv")):  # whisper cross K/V (L, B, F, K, D)
            spec = (None, b_ax, None, None, None)
        elif name.endswith(("k_scale", "v_scale")):  # int8 K/V (L, B, S, K)
            spec = (None, b_ax, s_ax, None)
        else:                            # attention K/V (L, B, S, K, D)
            spec = (None, b_ax, s_ax, None, None)
        return sanitize(spec, shape, mesh)

    return _map_paths(spec_for, cache)


def to_placements(spec: Spec, mesh: Any) -> Tuple:
    """The DTensor placements, one per mesh dim, of a spec on ``mesh``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, ``Replicate()``
    on the others.  A tuple entry shards one tensor dim over several mesh
    dims, which must come in the mesh's order (major to minor)."""
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names axes {missing} that the "
                             f"mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {d} must come in "
                             f"the mesh's order {names}")
        for i in idx:
            if placements[i] != Replicate():
                raise ValueError(f"spec {spec} shards two dims over mesh "
                                 f"axis {names[i]!r}")
            placements[i] = Shard(d)
    return tuple(placements)


# ---------------------------------------------------------------------------
# Activation layouts (installed as the models' constrain hook)
# ---------------------------------------------------------------------------


def activation_hook(mesh: Any, *, batch_sharded: bool,
                    seq_parallel: bool = False
                    ) -> Callable[[torch.Tensor, str], torch.Tensor]:
    """The hook that redistributes a DTensor activation to the reference's
    layout for its logical name; a plain tensor, or a name without a rule,
    passes through unchanged."""
    sizes = axis_sizes(mesh)
    dp = data_axes(sizes)

    def hook(x: torch.Tensor, name: str) -> torch.Tensor:
        if not isinstance(x, DTensor):
            return x
        if name == "btd" and x.ndim == 3 and batch_sharded:
            # Megatron-style sequence parallelism: between blocks the
            # activation also shards its sequence dim on "model".
            seq_ax = "model" if (seq_parallel and x.shape[1]
                                 % sizes["model"] == 0) else None
            spec = (dp, seq_ax, None)
        elif (name == "expert_in" and x.ndim == 4
              and x.shape[1] % sizes["model"] == 0):
            spec = (dp if batch_sharded else None, "model", None, None)
        else:
            return x
        return x.redistribute(mesh, to_placements(spec, mesh))

    return hook


def install_hook(mesh: Optional[Any], *, batch_sharded: bool = True,
                 seq_parallel: bool = False) -> None:
    """Install :func:`activation_hook` for ``mesh`` as the models' constrain
    hook, or remove it (``mesh=None``)."""
    cm.set_constrain_hook(None if mesh is None else activation_hook(
        mesh, batch_sharded=batch_sharded, seq_parallel=seq_parallel))
