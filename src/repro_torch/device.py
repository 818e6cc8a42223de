"""Device selection and host->device staging shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU: the
default ``device="cuda"`` raises on a machine without CUDA instead of falling
back quietly to the plain PyTorch path.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device` with its index resolved
    (``"cuda"`` is the current card, so it compares equal to the device its
    tensors report); raises when it names CUDA and no card is visible."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without blocking the host: CUDA
    uploads go through a pinned staging buffer as a non-blocking copy on the
    current stream (the caching host allocator keeps the buffer alive until
    the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def params_device(params) -> torch.device:
    """The device of the first tensor of a (nested) param tree, or the card
    (resolved, so it raises without one) when the tree holds no tensor."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return resolve_device(node.device)
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
    return resolve_device("cuda")
