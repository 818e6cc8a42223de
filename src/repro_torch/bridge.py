"""Param trees between the JAX reference and the port, through numpy.

Two tree shapes cross: the detector's ``ParamTree``, ``{uid: {"w", "b"} |
{"qw", "w_scale", "x_scale", "b"}}`` (integer node uids), and the LLM
families' nested trees, ``{"embed", "blocks", "final_norm"}`` with the
per-layer ``blocks`` stacked on a leading ``n_layers`` axis.  The port keeps
the same keys and layouts (a convolution's ``w`` stays HWIO, BatchNorm's
``gamma``/``beta``/``mean``/``var`` stay per channel).  Callers hand :func:`params_from_numpy` leaves that
``np.asarray`` accepts (a JAX array is one), so this module imports no JAX.
Dtypes are kept: integer codes stay integer, f32 stays f32, and bfloat16
leaves (numpy arrays of ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects) go through f32, which holds every bfloat16 exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import Device, resolve_device


def _leaf(v, dev: torch.device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _walk(tree: Mapping, dev: torch.device) -> Dict:
    return {k: _walk(v, dev) if isinstance(v, Mapping) else _leaf(v, dev)
            for k, v in tree.items() if v is not None}


def params_from_numpy(tree: Mapping, device: Device = "cuda") -> Dict:
    """A port param tree on ``device`` from a tree of array-likes.  Integer
    (node uid) keys of a detector tree come back as Python ints."""
    out = _walk(tree, resolve_device(device))
    return {k if isinstance(k, str) else int(k): v for k, v in out.items()}


def params_to_numpy(tree: Mapping) -> Dict[Any, Any]:
    """The inverse of :func:`params_from_numpy`: host numpy leaves
    (bfloat16 tensors come back as f32, numpy having no bfloat16)."""
    def leaf(v: torch.Tensor) -> np.ndarray:
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.numpy()
    return {k: params_to_numpy(v) if isinstance(v, Mapping) else leaf(v)
            for k, v in tree.items()}
