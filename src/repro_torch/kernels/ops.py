"""Public wrappers around the port's kernels: the ``repro.kernels.ops``
counterpart (``qmatmul``, ``fused_mlp`` and the grouped
``grouped_fused_mlp`` with the grouped fleet's packing; ``sparse_matmul``
behind :func:`sparse_dense`; ``ssd_scan`` behind :func:`ssd`;
``norm_codes`` behind :func:`rmsnorm_codes`).

The ``backend`` contract:

* ``"auto"`` launches the kernel for CUDA tensors and runs the plain version
  (``ref``) for CPU tensors;
* ``"kernel"`` launches the kernel and raises on CPU tensors (a CUDA kernel
  has no interpret mode);
* ``"ref"`` runs the plain version on either device;
* a mapping from kernel names (:data:`KERNELS`) to those three gives each
  kernel its own (a kernel it does not name takes ``"auto"``): a path that
  launches some kernels and runs the plain versions of others, so that one
  kernel can be held to its plain version end to end.

A CUDA tensor under ``"auto"`` launches the kernel or raises: nothing falls
back quietly.  No kernel has a backward, so a launch on a tensor that
requires grad (with grad mode on) raises too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import trace
from repro_torch.core.layers import ACTIVATIONS, Dense, Input, int_matmul
from repro_torch.core.prune import BlockSparseWeight
from repro_torch.kernels import (fused_mlp, norm_codes, qmatmul, ref,
                                 sparse_matmul, ssd_scan)
from repro_torch.kernels.fused_mlp import (GROUPED_ACT_IDS,
                                           GROUPED_KIND_LOGITS,
                                           GROUPED_KIND_SCORE, FusedLayer,
                                           FusedStack, GroupedLayer,
                                           GroupedStack)

LayerStack = Sequence[Tuple[Dict[str, torch.Tensor], str]]
BACKENDS = ("auto", "kernel", "ref")
KERNELS = ("qmatmul", "fused_mlp", "grouped_fused_mlp", "sparse_matmul",
           "ssd_scan", "norm_codes")
Backend = Union[str, Mapping[str, str]]


def _backend_of(backend: Backend, kernel: str) -> str:
    """The backend that ``backend`` gives ``kernel``."""
    if isinstance(backend, Mapping):
        unknown = set(backend) - set(KERNELS)
        if unknown:
            raise ValueError(f"backend names no kernel of {KERNELS}: "
                             f"{sorted(unknown)}")
        return backend.get(kernel, "auto")
    return backend


def _use_kernel(t: torch.Tensor, backend: Backend, kernel: str) -> bool:
    """Whether the call on activation ``t`` launches ``kernel`` (see the
    module docstring).  No kernel has a backward: a launch on a tensor
    that autograd records raises, where its output would silently carry no
    gradient.  A gradient takes the plain versions, asked for by name
    (``launch.steps.GRAD_BACKEND``; for ``ssd`` the chunked SSD, the
    reference's own gradient path off the TPU)."""
    backend = _backend_of(backend, kernel)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "ref":
        return False
    if t.device.type == "cuda":
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"the {kernel} kernel has no backward, and its input "
                "requires grad: differentiate the plain version (backend "
                f"{{{kernel!r}: 'ref'}}, or 'chunked' for ssd_scan; "
                "launch.steps.GRAD_BACKEND), or run under torch.no_grad()")
        return True
    if backend == "kernel":
        raise ValueError(
            f"backend='kernel' needs CUDA tensors: the {kernel} kernel has no "
            f"CPU mode (got a tensor on {t.device}); use backend='auto' or "
            "'ref' for the plain version")
    return False


def _per_column(v, n: int, device: torch.device) -> torch.Tensor:
    """A scalar or (n,) value as a contiguous (n,) f32 tensor on device."""
    return torch.as_tensor(v, dtype=torch.float32, device=device) \
        .broadcast_to((n,)).contiguous()


# ---------------------------------------------------------------------------
# Quantized matmul
# ---------------------------------------------------------------------------


def quantized_matmul(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale,
    bias: Optional[torch.Tensor] = None,
    *,
    backend: Backend = "auto",
) -> torch.Tensor:
    """``(xq @ wq) * scale + bias`` with int accumulation, f32 out.

    Runs where ``xq`` lies.  The kernel takes int8 only; the caller quantizes
    (``serving.core._dense_batched``).
    """
    if not _use_kernel(xq, backend, "qmatmul"):
        return ref.qmatmul_ref(xq, wq, scale, bias)
    n, dev = wq.shape[1], xq.device
    return qmatmul.qmatmul(
        xq.contiguous(), wq.contiguous(), _per_column(scale, n, dev),
        None if bias is None else _per_column(bias, n, dev))


# ---------------------------------------------------------------------------
# Fused whole-MLP forward (the detector's single-launch verdict step)
# ---------------------------------------------------------------------------


def dense_stack(model, params) -> list:
    """(params, activation) per Dense node in schedule order — the
    layer-stack layout shared by ``StreamEngine``, ``sim.detector`` and
    :func:`fused_forward`."""
    return [(params[n.uid], n.layer.activation)
            for n in model.graph.nodes if isinstance(n.layer, Dense)]


def model_fusable(model, stack: LayerStack) -> bool:
    """True when ``stack`` (built from ``model``) can run as one fused
    launch: every node is Input/Dense and the stack passes :func:`can_fuse`."""
    return (all(isinstance(n.layer, (Input, Dense))
                for n in model.graph.nodes)
            and can_fuse(stack))


def _weight(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["qw"] if "qw" in p else p["w"]


def _layer_reason(i: int, p: Dict[str, torch.Tensor], act: str, *,
                  final: bool, allow_final_softmax: bool) -> Optional[str]:
    """Per-layer fusability check shared by the single-stack and grouped
    paths: the grouped kernel masks a FINAL-layer softmax to the group's
    true width, so only it sets ``allow_final_softmax``."""
    if act not in fused_mlp.FUSED_ACTIVATIONS and not (
            allow_final_softmax and final and act == "softmax"):
        return (f"layer {i} activation {act!r} is not element-wise "
                f"(fusable: {sorted(fused_mlp.FUSED_ACTIVATIONS)})")
    if "qw" in p:
        if p["qw"].ndim != 2 or "w_scale" not in p or "x_scale" not in p:
            return (f"layer {i} quantized params are malformed "
                    "(need 2-D qw with w_scale and x_scale)")
    elif "w" not in p or p["w"].ndim != 2:
        return f"layer {i} has no 2-D dense weight"
    if _weight(p).dtype not in fused_mlp.MODES:
        return f"layer {i} weight dtype {_weight(p).dtype} has no kernel mode"
    return None


def _chain_reason(stack: LayerStack) -> Optional[str]:
    """Why consecutive layers of a stack do not chain (K_i != N_{i-1})."""
    for i in range(1, len(stack)):
        k, n_prev = _weight(stack[i][0]).shape[0], \
            _weight(stack[i - 1][0]).shape[1]
        if k != n_prev:
            return f"layer {i} takes {k} inputs but layer {i - 1} gives {n_prev}"
    return None


def fuse_reason(stack: LayerStack) -> Optional[str]:
    """None when a layer stack can run as one fused launch, else why not.

    The gate is the port kernel's own bill, not the TPU's VMEM budget or its
    lane/row granules: at most ``fused_mlp.MAX_LAYERS`` layers, element-wise
    activations, weight dtypes the kernel reads, and the shared memory of
    the stack's path (``fused_mlp.path``; ``fused_mlp.smem_bytes``) within
    Hopper's 232,448 bytes per block: two int8 code tiles of
    ``fused_mlp.BLOCK_M`` rows by the widest layer input (rounded up to the
    MMA depth, plus a 16-byte pad) and the kernel's step table when every
    layer is int8, else two f32 activation tiles of
    ``fused_mlp.BLOCK_M`` rows by the widest layer.
    """
    if not stack:
        return "empty layer stack"
    if len(stack) > fused_mlp.MAX_LAYERS:
        return (f"{len(stack)} layers exceed the kernel's descriptor array "
                f"of {fused_mlp.MAX_LAYERS}")
    for i, (p, act) in enumerate(stack):
        reason = _layer_reason(i, p, act, final=i == len(stack) - 1,
                               allow_final_softmax=False)
        if reason is not None:
            return reason
    reason = _chain_reason(stack)
    if reason is not None:
        return reason
    widths = [_weight(stack[0][0]).shape[0]] + [_weight(p).shape[1]
                                                for p, _ in stack]
    path = fused_mlp.path([_weight(p).dtype for p, _ in stack])
    smem = fused_mlp.smem_bytes(widths, path)
    if smem > fused_mlp.SMEM_PER_BLOCK:
        return (f"the fused kernel needs {smem} bytes of shared memory per "
                f"block ({_tiles(path, widths[:-1], max(widths))}), over "
                f"Hopper's {fused_mlp.SMEM_PER_BLOCK} bytes per block")
    return None


def _tiles(path: str, inputs: Sequence[int], widest: int,
           rows: int = fused_mlp.BLOCK_M) -> str:
    """The tiles of a path's shared-memory bill, in words."""
    if path == fused_mlp.INT8_MMA:
        return (f"two int8 code tiles of {rows} rows x "
                f"{fused_mlp.code_stride(inputs)} bytes and the kernel's "
                "step table")
    return (f"two f32 activation tiles of {fused_mlp.BLOCK_M} rows x "
            f"{widest} lanes")


def can_fuse(stack: LayerStack) -> bool:
    """True when a layer stack can run as one fused launch
    (:func:`fuse_reason` is the diagnosable form)."""
    return fuse_reason(stack) is None


def prepare_fused(stack: LayerStack) -> FusedStack:
    """Lay a fusable stack out for the kernel: per-column f32 bias and
    combined ``x_scale * w_scale``, the activation scale as a float, the
    K-major int8 weight copies of an all-int8 stack (``fused_mlp.path``) and
    the launch descriptor.  Costs a device-to-host read per quantized layer,
    so a caller that launches repeatedly (the serving engine) prepares
    once."""
    reason = fuse_reason(stack)
    if reason is not None:
        raise ValueError(f"layer stack is not fusable: {reason}")
    layers = []
    for p, act in stack:
        w = _weight(p)
        n, dev = w.shape[1], w.device
        bias = _per_column(p["b"] if "b" in p else 0.0, n, dev)
        if "qw" in p:
            layers.append(FusedLayer(
                w=w.contiguous(), bias=bias,
                scale=_per_column(p["x_scale"] * p["w_scale"], n, dev),
                x_scale=float(p["x_scale"]), act=act))
        else:
            layers.append(FusedLayer(
                w=w.to(torch.float32).contiguous(), bias=bias, scale=None,
                x_scale=None, act=act))
    return FusedStack(layers, source=stack)


def fused_forward(
    x: torch.Tensor,
    stack: Union[LayerStack, FusedStack],
    *,
    backend: Backend = "auto",
) -> torch.Tensor:
    """Whole Dense stack in ONE launch: ``x -> outputs`` (M, N_last).

    ``stack`` is ``[(layer_params, activation), ...]`` in schedule order
    (float ``w`` or §6.1-quantized ``qw``/``w_scale``/``x_scale`` per
    layer), or that stack already laid out by :func:`prepare_fused`.  Runs
    where ``x`` lies: the ``fused_mlp`` kernel on the card, the plain
    ``ref.fused_mlp_ref`` on the CPU (see the module docstring for
    ``backend``).
    """
    prepared = stack if isinstance(stack, FusedStack) else None
    source = stack if prepared is None else prepared.source
    if prepared is None:
        reason = fuse_reason(source)
        if reason is not None:
            raise ValueError(f"layer stack is not fusable: {reason}")
    if not _use_kernel(x, backend, "fused_mlp"):
        return ref.fused_mlp_ref(x, source)
    if prepared is None:
        prepared = prepare_fused(source)
    return fused_mlp.fused_mlp(x.to(torch.float32).contiguous(), prepared)


# ---------------------------------------------------------------------------
# Grouped fleet: a whole heterogeneous fleet in ONE launch
# ---------------------------------------------------------------------------


def _grouped_widths(stacks: Sequence[LayerStack],
                    k0: Optional[int] = None) -> Tuple[int, list]:
    """Tight-union arena geometry: per position l, K is the previous union
    width and N the widest active layer, widened to every *finished* group's
    true output so the skip pass-through never cuts a payload."""
    n_layers = max(len(s) for s in stacks)
    k0 = max(int(_weight(s[0][0]).shape[0]) for s in stacks) if k0 is None \
        else k0
    widths, prev = [], k0
    for l in range(n_layers):
        n = max(int(_weight(s[l][0]).shape[1]) if len(s) > l
                else int(_weight(s[-1][0]).shape[1]) for s in stacks)
        widths.append((prev, n))
        prev = n
    return k0, widths


def grouped_fuse_reason(stacks: Sequence[LayerStack], *,
                        names: Optional[Sequence[str]] = None,
                        k0: Optional[int] = None) -> Optional[str]:
    """None when a fleet of layer stacks can pack into ONE grouped launch,
    else why not.

    Beyond the per-stack :func:`fuse_reason` checks (relaxed to allow a
    FINAL-layer softmax, which the grouped kernel masks), the packed arena
    needs one weight dtype per layer position (one kernel mode), at most
    ``fused_mlp.MAX_LAYERS`` positions, and the kernel's shared-memory bill
    for the fleet's path (``fused_mlp.grouped_smem_bytes``: int8 code tiles
    and one f32 epilogue tile when every position is int8, else two f32
    tiles of ``fused_mlp.BLOCK_M`` rows by the widest union width) within
    Hopper's 232,448 bytes per block.  The shared-memory message carries the
    per-group slab accounting, so a ``megakernel=True`` failure names the
    group that widens the union.
    """
    if not stacks:
        return "no layer stacks"
    names = list(names) if names is not None else [
        f"group{g}" for g in range(len(stacks))]
    for g, stack in enumerate(stacks):
        if not stack:
            return f"{names[g]}: empty layer stack"
        for i, (p, act) in enumerate(stack):
            reason = _layer_reason(i, p, act, final=i == len(stack) - 1,
                                   allow_final_softmax=True)
            if reason is not None:
                return f"{names[g]}: {reason}"
        reason = _chain_reason(stack)
        if reason is not None:
            return f"{names[g]}: {reason}"
    widest = max(int(_weight(s[0][0]).shape[0]) for s in stacks)
    if k0 is not None and k0 < widest:
        return f"union input width {k0} is narrower than a group's {widest}"
    n_layers = max(len(s) for s in stacks)
    if n_layers > fused_mlp.MAX_LAYERS:
        return (f"{n_layers} layer positions exceed the kernel's descriptor "
                f"array of {fused_mlp.MAX_LAYERS}")
    for l in range(n_layers):
        dtypes = {_weight(s[l][0]).dtype for s in stacks if len(s) > l}
        if len(dtypes) > 1:
            return (f"layer position {l} mixes weight dtypes "
                    f"{sorted(str(d).removeprefix('torch.') for d in dtypes)} "
                    "across groups; "
                    "the packed arena needs one kernel mode per position")
    k0u, widths = _grouped_widths(stacks, k0)
    path = fused_mlp.path([_weight(s[l][0]).dtype for s in stacks
                           for l in range(len(s))])
    outs = [n for _, n in widths]
    smem = fused_mlp.grouped_smem_bytes(
        k0u, outs, path, max(int(_weight(s[-1][0]).shape[1])
                             for s in stacks))
    if smem > fused_mlp.SMEM_PER_BLOCK:
        slabs = [(names[g], sum(_weight(p).numel() * _weight(p).element_size()
                                for p, _ in stack))
                 for g, stack in enumerate(stacks)]
        widest = max(slabs, key=lambda s: s[1])[0]
        detail = ", ".join(f"{n}={b}B" for n, b in slabs)
        tiles = _tiles(path, [k0u] + outs[:-1], max([k0u] + outs),
                       fused_mlp.GROUPED_ROWS)
        return (f"the grouped kernel needs {smem} bytes of shared memory per "
                f"block ({tiles}, union widths), over "
                f"Hopper's {fused_mlp.SMEM_PER_BLOCK} bytes per block "
                f"(per-group slabs: {detail}; widest slab {widest!r} drives "
                "the union arena) — serve this fleet per group")
    return None


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """Static description of a packed heterogeneous fleet.

    Every field is a plain int/str tuple, so the plan is hashable and two
    fleets with identical geometry (shapes, dtypes, activations, head kinds)
    give equal plans; serving keys its cached mega steps on it.  The numbers
    (weight arenas, scales, the meta table, the per-group true stacks) live
    in the companion ``arrays`` from :func:`build_grouped_plan`.
    """

    n_groups: int
    k0: int                                   # union input width (tight)
    n_layers: int
    widths: Tuple[Tuple[int, int], ...]       # union (K, N) per position
    modes: Tuple[str, ...]                    # 'real' | 'int8' | 'emu'
    qmaxes: Tuple[int, ...]
    pos_acts: Tuple[Tuple[str, ...], ...]     # distinct acts per position
    acts: Tuple[Tuple[str, ...], ...]         # per group: its own stack acts
    skips: Tuple[Tuple[int, ...], ...]        # per group x position
    kinds: Tuple[int, ...]                    # GROUPED_KIND_* per group
    n_outs: Tuple[int, ...]                   # true final width per group
    true_k0s: Tuple[int, ...]                 # true input width per group
    n_out: int                                # union true final width
    payload_width: int                        # max(n_out | 1) over groups


def build_grouped_plan(
    stacks: Sequence[LayerStack],
    kinds: Sequence[int],
    *,
    k0: Optional[int] = None,
) -> Tuple[GroupedPlan, Dict]:
    """Pack per-group layer stacks into the grouped kernel's arena layout.

    Returns ``(plan, arrays)``: the hashable static plan and a dict of
    tensors on the stacks' device — per-position ``w``/``scale``/``bias``/
    ``x_scale`` arenas, the (G, 2+2L) int32 ``meta`` table (the reference's
    layout: kind, n_out, act ids, skips), the kernel's (G, 2+4L)
    ``kernel_meta`` (``meta`` followed by each group's true input and
    output width per position, so each product runs at its own widths; a
    skip slot carries the group's n_out in both), and the per-group true
    ``stacks`` params (what the plain version runs).  Pad slots are zeros
    (they meet zero weight rows); skip slots keep ``x_scale`` at 1 so
    quantizing them never divides by zero.

    ``k0`` widens the union input beyond the widest true input (serving
    passes the window width, so a head whose ``prepare`` drops trailing
    lanes — the forecast head — is handled by zero weight rows).
    """
    reason = grouped_fuse_reason(stacks, k0=k0)
    if reason is not None:
        raise ValueError(f"fleet cannot pack into one launch: {reason}")
    n_groups = len(stacks)
    n_layers = max(len(s) for s in stacks)
    device = _weight(stacks[0][0][0]).device
    k0u, widths = _grouped_widths(stacks, k0)
    true_k0s = tuple(int(_weight(s[0][0]).shape[0]) for s in stacks)
    n_outs = tuple(int(_weight(s[-1][0]).shape[1]) for s in stacks)
    kinds = tuple(int(k) for k in kinds)
    if len(kinds) != n_groups or not set(kinds) <= {GROUPED_KIND_LOGITS,
                                                    GROUPED_KIND_SCORE}:
        raise ValueError(f"need one GROUPED_KIND_* per group ({n_groups}), "
                         f"got {kinds}")
    payload_width = max(n if kind == GROUPED_KIND_LOGITS else 1
                        for n, kind in zip(n_outs, kinds))

    modes, qmaxes, pos_acts = [], [], []
    arenas: Dict[str, List[torch.Tensor]] = {
        "w": [], "scale": [], "bias": [], "x_scale": []}
    act_ids = torch.zeros((n_groups, n_layers), dtype=torch.int32)
    skips = torch.zeros((n_groups, n_layers), dtype=torch.int32)
    true_k = torch.tensor(n_outs, dtype=torch.int32)[:, None].repeat(
        1, n_layers)
    true_n = true_k.clone()
    for l, (k, n) in enumerate(widths):
        dtype = next(_weight(s[l][0]).dtype for s in stacks if len(s) > l)
        mode = fused_mlp._layer_mode(dtype)
        modes.append(mode)
        qmaxes.append(int(torch.iinfo(dtype).max) if mode != "real" else 0)
        w = torch.zeros((n_groups, k, n), dtype=dtype)
        sc = torch.zeros((n_groups, 1, n), dtype=torch.float32)
        bi = torch.zeros((n_groups, 1, n), dtype=torch.float32)
        xs = torch.ones((n_groups, 1), dtype=torch.float32)
        acts_here = set()
        for g, stack in enumerate(stacks):
            if len(stack) <= l:
                skips[g, l] = 1
                continue
            p, act = stack[l]
            wg = _weight(p).cpu()
            kg, ng = wg.shape
            true_k[g, l], true_n[g, l] = kg, ng
            w[g, :kg, :ng] = wg
            if "qw" in p:
                sc[g, 0, :ng] = (p["x_scale"] * p["w_scale"]).cpu() \
                    .to(torch.float32).broadcast_to((ng,))
                xs[g, 0] = p["x_scale"].cpu()
            if p.get("b") is not None:
                bi[g, 0, :ng] = p["b"].cpu().to(torch.float32) \
                    .broadcast_to((ng,))
            act_ids[g, l] = GROUPED_ACT_IDS[act]
            acts_here.add(act)
        pos_acts.append(tuple(sorted(acts_here)))
        for name, t in (("w", w), ("scale", sc), ("bias", bi),
                        ("x_scale", xs)):
            arenas[name].append(t.to(device))

    meta = torch.cat([torch.tensor(kinds, dtype=torch.int32)[:, None],
                      torch.tensor(n_outs, dtype=torch.int32)[:, None],
                      act_ids, skips], dim=1)
    arrays = dict(arenas, meta=meta.to(device),
                  kernel_meta=torch.cat([meta, true_k, true_n], dim=1)
                  .to(device),
                  stacks=[[p for p, _ in stack] for stack in stacks])
    plan = GroupedPlan(
        n_groups=n_groups, k0=k0u, n_layers=n_layers,
        widths=tuple(widths), modes=tuple(modes), qmaxes=tuple(qmaxes),
        pos_acts=tuple(pos_acts),
        acts=tuple(tuple(act for _, act in stack) for stack in stacks),
        skips=tuple(tuple(int(v) for v in row) for row in skips.tolist()),
        kinds=kinds, n_outs=n_outs, true_k0s=true_k0s,
        n_out=max(n_outs), payload_width=payload_width)
    return plan, arrays


def prepare_grouped(plan: GroupedPlan, arrays: Dict) -> GroupedStack:
    """Lay a packed fleet out for the grouped kernel: its arenas, their
    K-major int8 copies (when every position is int8), the kernel's meta
    table with the true widths and the launch descriptor.  Costs a
    device-to-host read of the table, so a caller that launches repeatedly
    (the serving engine's mega pack) prepares once and keeps the result,
    which owns the tensors the descriptor points into."""
    return GroupedStack(
        [GroupedLayer(w=arrays["w"][l], bias=arrays["bias"][l],
                      scale=arrays["scale"][l], x_scale=arrays["x_scale"][l])
         for l in range(plan.n_layers)],
        arrays["kernel_meta"], plan.payload_width)


def _grouped_acts_batched(y: torch.Tensor, plan: GroupedPlan, l: int,
                          meta: torch.Tensor) -> torch.Tensor:
    """Per-group activation select on a batched (G, M, N) tile, as the
    kernel: over the position's distinct activations, softmax masked to
    each group's true output width."""
    act_id = meta[:, 2 + l][:, None, None]
    out = y
    for name in plan.pos_acts[l]:
        if name == "softmax":
            n_outs = meta[:, 1][:, None, None]
            lanes = torch.arange(y.shape[-1], device=y.device)[None, None, :]
            z = torch.where(lanes < n_outs, y, -torch.inf)
            ez = torch.exp(z - z.amax(dim=-1, keepdim=True))
            a = ez / ez.sum(dim=-1, keepdim=True)
        else:
            a = ACTIVATIONS[name](y)
        if len(plan.pos_acts[l]) == 1:
            out = a
        else:
            out = torch.where(act_id == GROUPED_ACT_IDS[name], a, out)
    return out


def _fit_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` zero-padded or cut to ``n`` columns on its last axis."""
    if x.shape[-1] < n:
        return torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return x[..., :n]


def _grouped_forward_batched(x: torch.Tensor, plan: GroupedPlan,
                             arrays: Dict) -> torch.Tensor:
    """Tight-union batched forward for uniformly-int8 fleets: one batched
    exact integer product per layer position instead of one per group per
    layer.  Integer accumulation is exact, so this bit-matches the
    per-group path."""
    meta = arrays["meta"]
    h = x
    for l in range(plan.n_layers):
        xs = arrays["x_scale"][l][:, :, None]
        hq = torch.clamp(torch.round(h / xs), -plan.qmaxes[l], plan.qmaxes[l])
        acc = int_matmul(hq, arrays["w"][l]).to(torch.float32)
        y = acc * arrays["scale"][l] + arrays["bias"][l]
        y = _grouped_acts_batched(y, plan, l, meta)
        if any(row[l] for row in plan.skips):
            skip = meta[:, 2 + plan.n_layers + l][:, None, None]
            y = torch.where(skip == 1, _fit_cols(h, y.shape[-1]), y)
        h = y
    return h


def grouped_apply(
    x: torch.Tensor,
    plan: GroupedPlan,
    arrays: Dict,
    tgt: torch.Tensor,
    *,
    backend: Backend = "auto",
    prepared: Optional[GroupedStack] = None,
) -> torch.Tensor:
    """One forward + head epilogue for a packed heterogeneous fleet.

    Args:
      x: (G, M, plan.k0) f32: every group's window rows at the union input
        width.
      plan/arrays: from :func:`build_grouped_plan`; ``prepared`` is their
        :func:`prepare_grouped` layout, made here when not given.
      tgt: (G, M, plan.n_out) f32 epilogue targets: the window itself for
        reconstruction heads, its newest reading for forecast heads, the
        center row for margin heads, zeros for classifiers.

    Returns (G, M, plan.payload_width) f32 payloads: logits for
    ``GROUPED_KIND_LOGITS`` groups, the score in lane 0 for
    ``GROUPED_KIND_SCORE`` groups.

    Runs where ``x`` lies (see the module docstring for ``backend``): the
    ``grouped_fused_mlp`` kernel on the card, on the tight arenas, nothing
    padded; the plain version otherwise — per-group true-dimension math
    (``ref.grouped_mlp_ref``), or for uniformly-int8 fleets one batched
    integer product per position, which is bit-exact to it.
    """
    if not _use_kernel(x, backend, "grouped_fused_mlp"):
        if all(mode == "int8" for mode in plan.modes):
            h = _grouped_forward_batched(x, plan, arrays)
            pays = []
            for g in range(plan.n_groups):
                n = plan.n_outs[g]
                if plan.kinds[g] == GROUPED_KIND_LOGITS:
                    pay = h[g][:, :n]
                else:
                    pay = torch.mean(torch.square(h[g][:, :n] - tgt[g][:, :n]),
                                     dim=-1)[:, None]
                pays.append(_fit_cols(pay, plan.payload_width))
            return torch.stack(pays)
        return ref.grouped_mlp_ref(
            x, [list(zip(arrays["stacks"][g], plan.acts[g]))
                for g in range(plan.n_groups)],
            kinds=plan.kinds, true_k0s=plan.true_k0s, n_outs=plan.n_outs,
            tgt=tgt, n_pay=plan.payload_width)
    if prepared is None:
        prepared = prepare_grouped(plan, arrays)
    return fused_mlp.grouped_fused_mlp(
        x.to(torch.float32).contiguous(), prepared,
        tgt.to(torch.float32).contiguous())


# ---------------------------------------------------------------------------
# Block-sparse matmul (§6.2 pruning)
# ---------------------------------------------------------------------------


def sparse_dense(x: torch.Tensor, w: BlockSparseWeight, *,
                 backend: Backend = "auto") -> torch.Tensor:
    """Pruned matmul ``x @ w`` that skips zero blocks entirely."""
    if not _use_kernel(x, backend, "sparse_matmul"):
        return ref.sparse_matmul_ref(x, w)
    return sparse_matmul.sparse_matmul(x, w)


# ---------------------------------------------------------------------------
# SSD scan (mamba2)
# ---------------------------------------------------------------------------


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, backend: Backend = "auto",
        return_state: bool = False
        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Batched, grouped SSD scan.

    Args:
      x: (B, T, H, P); dt: (B, T, H) f32; a: (H,) f32;
      b/c: (B, T, G, N), G groups shared by H / G heads each.  x, b and c
        may be f32 or bf16 views (the conv output's channels).
      return_state: also return the final state S_T (B, H, P, N) f32, the
        layout of the decode cache's ssm arena.
    Returns y (B, T, H, P) f32, or ``(y, state)``.

    ``backend``: ``"auto"`` (the kernel for CUDA tensors, ``"chunked"``
    for CPU tensors), ``"kernel"``, ``"ref"`` (the sequential recurrence,
    :func:`ref.ssd_scan_ref`, the whole batch stepped together) or
    ``"chunked"`` (the chunk-parallel plain version,
    :func:`ref.ssd_chunked_ref`, at ``ssd_scan.CHUNK``); the plain versions
    take the state from :func:`ref.ssd_final_state_ref`.  The kernel covers
    the whole batch in one launch, reads x, B and C where they lie (by
    group, no repeat to heads; a copy only for a view it cannot read) and
    takes any T, treating the steps past T as dt = 0; ``"chunked"`` pads T
    so, with zeros (steps with dt = 0 contribute nothing), as the
    reference's Pallas wrapper pads.
    """
    if isinstance(x, DTensor):
        # No two batch rows meet in the scan: each rank scans its own.
        return rowwise(
            lambda *t: ssd(*t, backend=backend, return_state=return_state),
            (x, dt), (a,), (b, c), n_out=2 if return_state else 1)
    backend = _backend_of(backend, "ssd_scan")
    if backend == "chunked" or backend == "ref" or not _use_kernel(
            x, backend, "ssd_scan"):
        x, b, c = (v.to(torch.float32) for v in (x, b, c))
        bsz, t, h = x.shape[:3]
        reps = h // b.shape[2]
        b_full = torch.repeat_interleave(b, reps, dim=2)
        c_full = torch.repeat_interleave(c, reps, dim=2)
        if backend == "ref":
            y = ref.ssd_scan_ref(x, dt, a, b_full, c_full)
        else:
            pad = (-t) % ssd_scan.CHUNK
            xp, dtp, bp, cp = (
                torch.nn.functional.pad(v, (0, 0) * (v.ndim - 2) + (0, pad))
                for v in (x, dt, b_full, c_full))
            y = torch.stack([
                ref.ssd_chunked_ref(xp[i], dtp[i], a, bp[i], cp[i],
                                    chunk=ssd_scan.CHUNK)
                for i in range(bsz)])[:, :t]
        if not return_state:
            return y
        return y, ref.ssd_final_state_ref(x, dt, a, b)
    x, b, c = (v if ssd_scan.reads(v)
               else v.clone(memory_format=torch.contiguous_format)
               for v in (x, b, c))
    return ssd_scan.ssd_scan(x, dt.contiguous(), a.contiguous(), b, c,
                             return_state=return_state)


# ---------------------------------------------------------------------------
# RMSNorm into a SINT projection's codes (mamba2)
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., W) as (M, W) rows with packed columns: a view where one
    row stride reaches every row (the conv output's channels), a copy
    otherwise."""
    rows = t.reshape(-1, t.shape[-1])
    return rows if rows.stride(-1) == 1 else rows.contiguous()


def rmsnorm_codes(x: torch.Tensor, g: torch.Tensor, x_scale: torch.Tensor,
                  *, xs: Optional[torch.Tensor] = None,
                  d_skip: Optional[torch.Tensor] = None,
                  z: Optional[torch.Tensor] = None, eps: float = 1e-6,
                  backend: Backend = "auto") -> torch.Tensor:
    """The int8 codes (M, W) that a SINT projection with activation scale
    ``x_scale`` takes from ``rmsnorm(u) * g`` over the rows of ``x`` (...,
    W), M the product of the leading dimensions: u = x (a block's
    pre-norm), or the Mamba-2 mixer's gated norm (``xs``, ``d_skip`` and
    ``z`` together) as :func:`ref.norm_codes_ref` composes it.  The
    ``norm_codes`` kernel reads ``xs`` and ``z`` where they lie when their
    rows share one stride; each launch counts ``model.norm_codes`` in
    :mod:`repro_torch.trace`.

    A DTensor takes the plain version, its ops dispatched by DTensor: a
    mesh shards the gated norm's d_inner over ``"model"`` (out_proj's
    rows), so no rank holds a whole row to norm, and the plain ops make
    the reduction's collective.
    """
    if isinstance(x, DTensor) or not _use_kernel(x, backend, "norm_codes"):
        return ref.norm_codes_ref(x, g, x_scale, xs=xs, d_skip=d_skip, z=z,
                                  eps=eps)
    trace.count("model.norm_codes")
    return norm_codes.norm_codes(
        _rows(x), g.contiguous(), x_scale,
        xs=None if xs is None else _rows(xs),
        d_skip=None if d_skip is None else d_skip.contiguous(),
        z=None if z is None else _rows(z), eps=eps)


def rowwise(fn, batched: Sequence[torch.Tensor],
            shared: Sequence[torch.Tensor] = (),
            more_batched: Sequence[torch.Tensor] = (), *, n_out: int = 1):
    """``fn(*batched, *shared, *more_batched)``, an op in which no two batch
    rows meet, on DTensor operands: each rank runs ``fn`` on its own rows of
    the batched operands (dim 0 sharded as the first one's, every other dim
    whole) with the ``shared`` ones (params) whole, and its ``n_out``
    outputs keep the rows' sharding.  A shared operand's gradient is a
    partial sum over the row shards."""
    first = batched[0]
    mesh = first.device_mesh
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                 for pl in first.placements)
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if pl.is_shard(0) else Replicate() for pl in rows)
    args = [v if isinstance(v, DTensor) else DTensor.from_local(
        v, mesh, rep, run_check=False)
        for v in (*batched, *shared, *more_batched)]
    kinds = ([rows] * len(batched) + [rep] * len(shared)
             + [rows] * len(more_batched))
    grads = ([rows] * len(batched) + [part] * len(shared)
             + [rows] * len(more_batched))
    fn = local_map(
        fn,
        # One output's placements are a list: local_map reads a tuple as
        # one entry per output.
        out_placements=(rows,) * n_out if n_out > 1 else list(rows),
        in_placements=tuple(kinds), in_grad_placements=tuple(grads),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)
