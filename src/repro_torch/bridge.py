"""Param trees between the JAX reference and the port, through numpy.

A ``repro`` ``ParamTree`` is ``{uid: {"w", "b"} | {"qw", "w_scale",
"x_scale", "b"}}``; the port keeps the same keys and uids.  Callers hand
:func:`params_from_numpy` leaves that ``np.asarray`` accepts (a JAX array is
one), so this module imports no JAX.  Dtypes are kept: int8/int16/int32
codes stay integer, scales and float weights stay f32.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.model import ParamTree
from repro_torch.device import Device, resolve_device


def params_from_numpy(tree: Mapping, device: Device = "cuda") -> ParamTree:
    """A port param tree on ``device`` from a tree of array-likes."""
    dev = resolve_device(device)
    return {int(uid): {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
                       for k, v in p.items() if v is not None}
            for uid, p in tree.items()}


def params_to_numpy(tree: ParamTree) -> Dict[int, Dict[str, np.ndarray]]:
    """The inverse of :func:`params_from_numpy`: host numpy leaves."""
    return {uid: {k: v.detach().cpu().numpy() for k, v in p.items()}
            for uid, p in tree.items()}
