"""Train and serve steps (``repro.launch.steps``'s counterpart).

The reference returns functions for ``jax.jit`` with donated params and
optimizer state; here the train step runs eagerly and updates both in place
(``optim.adamw``).  Its gradient goes through the plain versions of the
kernels: the step differentiates the model built with :data:`GRAD_BACKEND`,
whatever backend the given API serves with, since no kernel of the port has
a backward (``kernels.ops`` raises if one is asked for a gradient).  Off
the TPU the reference's gradient takes the same path, the chunked SSD.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models.api import Batch, ModelAPI, Params, get_model
from repro_torch.optim import (adamw, apply_updates, global_norm,
                               linear_warmup_cosine)
from repro_torch.optim.adamw import leaves, tree_map

# The plain versions a gradient runs through (ops.Backend).
GRAD_BACKEND = {"ssd_scan": "chunked", "qmatmul": "ref"}


def make_optimizer(lr: float = 3e-4, warmup: int = 100, steps: int = 10_000):
    return adamw(linear_warmup_cosine(lr, warmup, steps))


def loss_and_grads(api: ModelAPI, params: Params, batch: Batch
                   ) -> Tuple[torch.Tensor, Any]:
    """``jax.value_and_grad(api.loss)`` of the model built with
    :data:`GRAD_BACKEND`: the loss (0-d f32, detached) and a gradient tree
    like ``params`` (integer leaves get zeros; a float leaf the loss does
    not reach gets zeros, as ``jax.grad`` gives)."""
    loss_fn = get_model(api.cfg, backend=GRAD_BACKEND).loss
    trainable: List[torch.Tensor] = [p for p in leaves(params)
                                     if p.is_floating_point()]
    for p in trainable:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            flat = torch.autograd.grad(loss, trainable, allow_unused=True)
    finally:
        for p in trainable:
            p.requires_grad_(False)
    by_id = {id(p): g for p, g in zip(trainable, flat)}

    def grad_of(p):
        g = by_id.get(id(p))
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, params)


def make_train_step(api: ModelAPI, opt_update) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: loss and gradient (:func:`loss_and_grads`),
    the optimizer's update, and the update applied to ``params`` in
    place."""
    def train_step(params: Params, opt_state, batch: Batch):
        loss, grads = loss_and_grads(api, params, batch)
        updates, opt_state = opt_update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return params, opt_state, metrics

    return train_step


def make_prefill(api: ModelAPI, cache_len: int) -> Callable:
    def prefill_step(params: Params, batch: Batch):
        return api.prefill(params, batch, cache_len)

    return prefill_step


def make_decode_step(api: ModelAPI) -> Callable:
    def decode_step(params: Params, cache: Dict[str, Any], batch: Batch, pos):
        return api.decode(params, cache, batch, pos)

    return decode_step
