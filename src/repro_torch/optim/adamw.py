"""AdamW and SGD over the port's nested param dicts
(``repro.optim.adamw``'s counterpart).

The arithmetic is the reference's, in its order: the global-norm clip first
(``scale = min(1, clip / (gnorm + 1e-9))``) on gradients upcast to f32 (in
JAX a bf16 gradient times the f32 ``scale`` promotes to f32; in PyTorch it
would stay bf16), f32 moments whatever the parameter's dtype, the bias
corrections in f32, ``upd = mhat / (sqrt(vhat) + eps) + wd * p``, and
``-lr * upd`` cast to the parameter's dtype before it is added.  Integer
leaves (quantized weights) are not updated and their moments are 0-d zeros.
``torch.optim.AdamW`` is not this: it decays ``p`` before the step, adds
``eps`` after dividing by ``sqrt(bc2)``, keeps moments in the parameter's
dtype and has no global-norm clip.

On a mesh (``launch.steps.make_sharded_train_step``) params are DTensors.
Each moment is then a DTensor with its param's placements (a 0-d moment
replicates: ``launch.shardings.opt_shardings``), the update runs on each
rank's local shards of gradient, moments and param (it is elementwise once
the clip's scale is known), and each param shard is written in place.  The
gradients must carry their params' placements (no pending sums).
:func:`global_norm` sums each leaf over the mesh, leaf by leaf in the
reference's order.  The step stays a host 0-d int32 on every rank: every
rank counts the same steps, so it is replicated by construction.

The reference's jitted train step donates the optimizer state; here
``update`` writes the new moments into the state's moment tensors, in place,
and returns a state holding them with the next step.  Copy a state (its
``mu``/``nu`` trees) before an update if the old one must survive.  Leaves
are visited in the reference's order: ``jax.tree`` flattens dicts by sorted
key, so the f32 sums of :func:`global_norm` add up in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the host
    mu: Tree             # first moment (f32, like params)
    nu: Tree             # second moment (f32)


def _trainable(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point()


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict in the reference's order (dict keys
    sorted at every level, as ``jax.tree.leaves``)."""
    return list(_walk(tree))


def _walk(tree: Tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif tree is not None:
        yield tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the same places of ``rest``),
    keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _zeros_state(p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor):
        if _trainable(p):
            return torch.zeros_like(p, dtype=torch.float32)
        mesh = p.device_mesh
        return DTensor.from_local(
            torch.zeros((), dtype=torch.float32, device=p.to_local().device),
            mesh, [Replicate()] * mesh.ndim, run_check=False)
    shape = p.shape if _trainable(p) else ()
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _shardwise(fn: Callable) -> Callable:
    """``fn(g, *state, p)``, an elementwise update of one leaf, run on the
    local shards when ``p`` is a trainable DTensor (every operand with its
    placements); the update comes back as a DTensor like ``p``."""
    def run(g, *rest):
        p = rest[-1]
        if not (isinstance(p, DTensor) and _trainable(p)):
            return fn(g, *rest)
        for t in (g,) + rest:
            if t.placements != p.placements:
                raise ValueError(
                    f"an update needs every operand with its param's "
                    f"placements {p.placements}, got {t.placements} (a "
                    "gradient is redistributed to its param's first)")
        local = fn(*(t.to_local() for t in (g,) + rest))
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False)

    return run


def _init_state(params: Tree) -> OptState:
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=tree_map(_zeros_state, params),
                    nu=tree_map(_zeros_state, params))


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float, *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: Optional[float] = 1.0):
    """``(init, update)`` in the optax convention.  ``lr`` is a float or a
    schedule of the (1-based) step (:mod:`repro_torch.optim.schedules`).
    ``update(grads, state, params) -> (updates, state)``: the updates in
    each parameter's dtype (zeros for integer leaves); the state's moments
    are updated in place (see the module docstring)."""
    lr_fn = lr if callable(lr) else (
        lambda _: torch.tensor(lr, dtype=torch.float32))

    def update(grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState]:
        step = state.step + 1
        scale = None
        if grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = step.to(torch.float32)
        b1t = torch.tensor(b1, dtype=torch.float32)
        b2t = torch.tensor(b2, dtype=torch.float32)
        bc1 = 1 - b1t ** stepf
        bc2 = 1 - b2t ** stepf
        neg_lr = -lr_fn(step)

        @_shardwise
        def one(g, m, v, p):
            if not _trainable(p):
                return torch.zeros_like(p)
            g = g.to(torch.float32)
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            denom = torch.sqrt(v / bc2).add_(eps)
            upd = (m / bc1).div_(denom).add_(weight_decay
                                             * p.to(torch.float32))
            return (neg_lr * upd).to(p.dtype)

        with torch.no_grad():
            updates = tree_map(one, grads, state.mu, state.nu, params)
        return updates, OptState(step=step, mu=state.mu, nu=state.nu)

    return _init_state, update


def sgd(lr: float, momentum: float = 0.0):
    """``(init, update)``: ``mu = momentum * mu + g`` (f32, in place),
    updates ``-lr * mu`` in each parameter's dtype."""
    def update(grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState]:
        @_shardwise
        def one(g, m, p):
            if not _trainable(p):
                return torch.zeros_like(p)
            m.mul_(momentum).add_(g.to(torch.float32))
            return (-lr * m).to(p.dtype)

        with torch.no_grad():
            updates = tree_map(one, grads, state.mu, params)
        return updates, OptState(step=state.step + 1, mu=state.mu,
                                 nu=state.nu)

    return _init_state, update


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` in the parameter's dtype, written into each float leaf in
    place (the reference's donated params); returns ``params``."""
    def one(p, u):
        if _trainable(p):
            p.add_(u.to(p.dtype))
        return p

    with torch.no_grad():
        return tree_map(one, params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt`` of the f32 sum of every leaf's f32 sum of squares, leaf by
    leaf in the reference's order (one leaf's f32 copy at a time).  A
    DTensor leaf's sum is taken over the whole mesh; the result is a plain
    0-d tensor on every rank."""
    total = None
    with torch.no_grad():
        for x in leaves(tree):
            s = torch.sum(torch.square(x.to(torch.float32)))
            if isinstance(s, DTensor):
                s = s.full_tensor()
            total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)
