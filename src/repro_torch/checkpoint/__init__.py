"""Checkpointing (``repro.checkpoint``'s counterpart): save and restore
param and optimizer trees as raw ``.npy`` leaves keyed by their tree path
(the paper's BINARR/ARRBIN spirit, §4.3), with a manifest of shapes and
dtypes for validation and step-numbered directories behind an atomic
``LATEST`` marker."""

from repro_torch.checkpoint.npz import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
