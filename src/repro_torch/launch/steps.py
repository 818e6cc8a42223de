"""Train and serve steps (``repro.launch.steps``'s counterpart).

The reference returns functions for ``jax.jit`` with donated params and
optimizer state; here the train step runs eagerly and updates both in place
(``optim.adamw``).  Its gradient goes through the plain versions of the
kernels: the step differentiates the model built with :data:`GRAD_BACKEND`,
whatever backend the given API serves with, since no kernel of the port has
a backward (``kernels.ops`` raises if one is asked for a gradient).  Off
the TPU the reference's gradient takes the same path, the chunked SSD.

:func:`make_sharded_train_step` is the reference's train step jitted on a
mesh (``in_shardings=(p_shard, o_shard, b_shard)``,
``out_shardings=(p_shard, o_shard, None)``): params and moments are
DTensors laid out by ``launch.shardings`` (``shard_params``; an optimizer
state made from them, or ``shard_opt_state``), the batch goes through
``shard_batch``, and the activation hook is installed for the step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import shardings as sh
from repro_torch.models.api import Batch, ModelAPI, Params, get_model
from repro_torch.optim import (adamw, apply_updates, global_norm,
                               linear_warmup_cosine)
from repro_torch.optim.adamw import leaves, tree_map

# The plain versions a gradient runs through (ops.Backend).
GRAD_BACKEND = {"ssd_scan": "chunked", "qmatmul": "ref", "norm_codes": "ref"}


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
            if isinstance(loss, DTensor):
                # One replicated scalar: autograd seeds it with 1 once.
                loss = loss.full_tensor()
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


def make_sharded_train_step(api: ModelAPI, opt_update, mesh: Any
                            ) -> Callable:
    """:func:`make_train_step` on ``mesh``: ``train_step(params, opt_state,
    batch)`` with params and moments laid out by the sharding rules and a
    global batch (plain tensors, the same on every rank, or already laid
    out).  The gradients come back from autograd as pending sums over the
    data axes (and over ``"model"`` for input-sharded weights); each is
    redistributed to its param's placements before the update, so params
    and moments keep the placements they came in with."""
    cfg = api.cfg

    def train_step(params: Params, opt_state, batch: Batch):
        if not all(isinstance(v, DTensor) for v in batch.values()):
            batch = sh.shard_batch(batch, mesh)
        with sh.hooked(mesh, batch_sharded=True,
                       seq_parallel=cfg.seq_parallel):
            loss, grads = loss_and_grads(api, params, batch)
        grads = tree_map(
            lambda g, p: g.redistribute(p.device_mesh, p.placements)
            if g.placements != p.placements else g, grads, params)
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
