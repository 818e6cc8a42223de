"""Filesystem checkpoint format (``repro.checkpoint.npz``'s counterpart):
one ``.npy`` per leaf, a manifest, an atomic ``LATEST`` marker.

The on-disk format is the reference's, so a checkpoint either package
writes restores in the other bit for bit: each leaf is named by its
``/``-joined dict path (keys sorted, as ``jax.tree`` flattens dicts) with
``/`` turned into ``__``; a bfloat16 leaf is stored as its ``uint16`` bit
pattern with manifest dtype ``"bfloat16"`` and read back through an
``int16`` view (numpy has no bfloat16, and this package needs no
``ml_dtypes``); a step is written to ``step_XXXXXXXX.tmp`` and renamed
whole before ``LATEST`` moves to it.

A tree of DTensors (a sharded train step's params and moments) is saved
whole: every rank gathers each leaf (``full_tensor``, a collective), rank 0
writes the files, and all meet at a barrier before ``save`` returns.  A
DTensor leaf of ``restore``'s ``tree_like`` is read whole on every rank and
laid out again with that leaf's placements, each rank keeping its shards.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import Device, resolve_device

BF16 = "bfloat16"


def _flatten_with_paths(tree: Any, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}{k}/")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The array to store and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree: Any) -> str:
    """Write a checkpoint of ``tree`` (nested dicts of tensors or arrays)
    for ``step``; returns the checkpoint directory.  With DTensor leaves
    every rank of their mesh calls this (module docstring)."""
    flat = _flatten_with_paths(tree)
    if any(isinstance(leaf, DTensor) for _, leaf in flat):
        flat = [(k, leaf.full_tensor() if isinstance(leaf, DTensor)
                 else leaf) for k, leaf in flat]
        writer = dist.get_rank() == 0
        try:
            return _write(directory, step, flat) if writer else \
                os.path.join(directory, f"step_{step:08d}")
        finally:
            dist.barrier()
    return _write(directory, step, flat)


def _write(directory: str, step: int, flat: List[Tuple[str, Any]]) -> str:
    ckpt = os.path.join(directory, f"step_{step:08d}")
    tmp = ckpt + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for key, leaf in flat:
        arr, dtype_name = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
    if os.path.exists(ckpt):
        raise FileExistsError(ckpt)
    os.rename(tmp, ckpt)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return ckpt


def latest_step(directory: str) -> Optional[int]:
    marker = os.path.join(directory, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype_name:
        raise ValueError(f"stored as {arr.dtype}, manifest says "
                         f"{dtype_name}")
    return torch.from_numpy(arr)


def restore(directory: str, tree_like: Any, step: Optional[int] = None, *,
            device: Device = "cuda") -> Any:
    """Restore into the structure of ``tree_like``, a tree of tensors (on
    the ``meta`` device or any other) giving each leaf's shape and dtype;
    shapes are validated (``ValueError``), a leaf the checkpoint lacks
    raises ``KeyError``.  Each leaf lands on its ``like``'s device, or on
    ``device`` for a ``meta`` one (the card unless the caller asks for
    the CPU); a DTensor ``like`` gives a DTensor with its placements on
    its mesh."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    def load(key: str, like: torch.Tensor) -> torch.Tensor:
        meta = manifest.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(ckpt, meta["file"]))
        want_shape = tuple(like.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{key}: shape {arr.shape} != expected "
                             f"{want_shape}")
        if isinstance(like, DTensor):
            whole = _from_numpy(arr, meta["dtype"]).to(
                like.to_local().device, dtype=like.dtype)
            return distribute_tensor(whole, like.device_mesh,
                                     like.placements, src_data_rank=None)
        dev = resolve_device(device) if like.device.type == "meta" \
            else like.device
        return _from_numpy(arr, meta["dtype"]).to(dev, dtype=like.dtype)

    def walk(like: Any, prefix: str) -> Any:
        if isinstance(like, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in like.items()}
        return load(prefix[:-1], like)

    return walk(tree_like, "")
