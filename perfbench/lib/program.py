"""What the benchmark takes from the program: its configuration, its model
API, its own quantizer (the set-up step that derives integer codes from
the drawn weights), its engines, and records of its kernel launches.

This is the only module of the harness's library that imports the
program (``repro_torch``); the reference and the yardstick never do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List

import torch

from perfbench.lib.weights import Weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(config: Dict[str, Any]):
    """The program's ``ArchConfig``: its registered architecture with the
    configuration file's ``program`` overrides."""
    from repro_torch.configs.base import get_config
    prog = dict(config["program"])
    over = {k: _DTYPES.get(v, v) if k == "dtype" else v
            for k, v in prog.get("overrides", {}).items()}
    return get_config(prog["arch"]).with_(**over)


def model_api(cfg):
    from repro_torch.models.api import get_model
    return get_model(cfg)


def template(cfg):
    """The program's parameter tree for ``cfg`` as ``meta`` tensors: its
    init run under a ``FakeTensorMode``, which draws nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model_api(cfg).init(torch.Generator(), device="cpu")

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node.shape, dtype=node.dtype, device="meta")
    return meta(fake)


def weights(cfg, seed: int, device: torch.device) -> Weights:
    """The drawn inputs: every leaf of the float (unquantized) tree."""
    return Weights(template(cfg.with_(quant=None)), seed, device)


def _quantize_stacked(w: torch.Tensor, scheme: str):
    """Per-layer per-channel codes of a stacked (..., d_in, d_out) weight,
    each layer through the program's ``quantize_tensor``, as its linear
    layers quantize one weight at a time."""
    from repro_torch.core.quantize import quantize_tensor
    lead = tuple(w.shape[:-2])
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(lead + (w.shape[-1],), dtype=torch.float32,
                        device=w.device)
    for idx in itertools.product(*(range(s) for s in lead)):
        qt = quantize_tensor(w[idx].to(torch.float32), scheme)
        q[idx].copy_(qt.q)
        scale[idx].copy_(qt.scale)
    return q, scale, lead


def params(cfg, drawn: Weights) -> Dict[str, Any]:
    """The program's parameter tree built from the drawn leaves: a linear
    layer that ``cfg`` quantizes gets codes and scales from its drawn
    weight, which is then dropped (the reference draws it again); every
    other leaf is the drawn tensor itself."""
    quant_tree = template(cfg)

    def build(node, path):
        if isinstance(node, dict) and "qw" in node:
            w = drawn.draw(path + ("w",))
            q, scale, lead = _quantize_stacked(w, cfg.quant)
            del w
            qmax = float(torch.iinfo(q.dtype).max)
            out = {"qw": q, "w_scale": scale,
                   "x_scale": torch.full(lead, 1.0 / qmax,
                                         dtype=torch.float32,
                                         device=q.device)}
            for k in node:
                if k not in out:
                    out[k] = drawn.get(path + (k,))
            return out
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        return drawn.get(path)
    return build(quant_tree, ())


@dataclasses.dataclass
class Launches:
    """Shapes of the kernel launches made while recording."""
    qmatmul: List[dict] = dataclasses.field(default_factory=list)
    ssd_scan: List[dict] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def recording_launches():
    """Record the (m, k, n) and path of every ``qmatmul`` launch and the
    shapes of every ``ssd_scan`` launch, by wrapping the program's kernel
    entry points (``ops`` calls them as module attributes)."""
    from repro_torch.kernels import qmatmul, ssd_scan
    rec = Launches()
    q_orig, s_orig = qmatmul.qmatmul, ssd_scan.ssd_scan

    def q_wrap(xq, wq, scale, bias=None):
        m = xq.shape[0]
        rec.qmatmul.append(dict(m=m, k=xq.shape[1], n=wq.shape[1],
                                path=qmatmul.path(m)))
        return q_orig(xq, wq, scale, bias)

    def s_wrap(x, dt, a, b, c, *, return_state=False):
        rec.ssd_scan.append(dict(
            bsz=x.shape[0], t=x.shape[1], h=x.shape[2], p=x.shape[3],
            g=b.shape[2], n=b.shape[3], in_dtype=str(x.dtype).split(".")[-1],
            in_bytes=sum(v.numel() * v.element_size() for v in (x, b, c)),
            state=return_state))
        return s_orig(x, dt, a, b, c, return_state=return_state)

    qmatmul.qmatmul, ssd_scan.ssd_scan = q_wrap, s_wrap
    try:
        yield rec
    finally:
        qmatmul.qmatmul, ssd_scan.ssd_scan = q_orig, s_orig

