"""Integer quantization for ICSML models (§6.1, Table 2): the counterpart of
``repro.core.quantize``.

Symmetric per-channel weight quantization to the IEC 61131-3 integer types
SINT (int8), INT (int16) and DINT (int32) with REAL (f32) scales, plus one
per-tensor activation scale per Dense layer.  Codes and scales are
bit-identical to the reference's for the same f32 inputs: every step is the
same correctly rounded f32 operation (division by the scale, half-even
rounding, symmetric clip).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.layers import TORCH_INT_TYPES, Dense, IEC_INT_TYPES
from repro_torch.core.model import Model, ParamTree
from repro_torch.device import Device, params_device, resolve_device

SCHEMES = ("SINT", "INT", "DINT")  # REAL == unquantized


def _int_dtype(scheme: str) -> torch.dtype:
    try:
        return TORCH_INT_TYPES[scheme]
    except KeyError:
        raise ValueError(
            f"unknown quantization scheme {scheme!r}; pick from {SCHEMES}")


def _saturating_cast(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float -> int cast that saturates at the type's range, as XLA's does.

    The f32 clip rail of DINT is f32(2**31 - 1) == 2**31, which torch's cast
    would wrap to -2**31; clamping in float64 first pins it to 2**31 - 1."""
    info = torch.iinfo(dtype)
    return v.to(torch.float64).clamp(info.min, info.max).to(dtype)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    q: torch.Tensor        # integer representation
    scale: torch.Tensor    # REAL scaling factor(s): () or (out_channels,)

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale


def quantize_tensor(w: torch.Tensor, scheme: str, *, per_channel: bool = True,
                    axis: int = -1) -> QuantizedTensor:
    """Symmetric integer quantization with REAL scaling factors."""
    dtype = _int_dtype(scheme)
    qmax = float(torch.iinfo(dtype).max)
    if per_channel and w.ndim >= 2:
        reduce = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
        absmax = torch.amax(torch.abs(w), dim=reduce)
    else:
        absmax = torch.amax(torch.abs(w))
    scale = torch.clamp_min(absmax, 1e-12) / qmax
    # Symmetric clip to [-qmax, qmax]: the scale is derived from qmax, so the
    # extra negative code would decode outside the calibrated range.
    q = _saturating_cast(torch.clamp(torch.round(w / scale), -qmax, qmax),
                         dtype)
    return QuantizedTensor(q=q, scale=scale.to(torch.float32))


def calibrate_activation_scales(
    model: Model, params: ParamTree, samples: Iterable[torch.Tensor],
    scheme: str,
) -> Dict[int, torch.Tensor]:
    """Per-node activation scales from representative data: each Dense
    node's input absmax over ``samples``, divided by the scheme's qmax."""
    qmax = float(torch.iinfo(_int_dtype(scheme)).max)
    device = params_device(params)
    absmax: Dict[int, torch.Tensor] = {}
    for x in samples:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        values: Dict[int, torch.Tensor] = {}
        for node in model.graph.nodes:
            inputs = [values[r] for r in node.inputs] or [x]
            if isinstance(node.layer, Dense):
                m = torch.amax(torch.abs(inputs[0]))
                prev = absmax.get(node.uid)
                absmax[node.uid] = m if prev is None else torch.maximum(prev, m)
            values[node.uid] = node.layer.apply(params[node.uid], inputs)
    return {uid: (torch.clamp_min(m, 1e-12) / qmax).to(torch.float32)
            for uid, m in absmax.items()}


def calibration_samples(x, labels=None, *, k: int = 32,
                        device: Device = "cuda") -> List[torch.Tensor]:
    """Representative-input samples for :func:`calibrate_activation_scales`,
    drawn evenly from the *benign* rows of a dataset (``labels`` drops attack
    rows when given), as f32 tensors on ``device``."""
    dev = resolve_device(device)
    x = np.asarray(x)
    if labels is not None:
        x = x[np.asarray(labels) == 0]
    if len(x) == 0:
        raise ValueError("no benign rows to calibrate on")
    idx = np.linspace(0, len(x) - 1, min(k, len(x))).astype(int)
    return [torch.from_numpy(np.asarray(x[i], np.float32)).to(dev)
            for i in idx]


def quantize_params(
    model: Model,
    params: ParamTree,
    scheme: str,
    *,
    per_channel: bool = True,
    calibration: Optional[Sequence[torch.Tensor]] = None,
    only_nodes: Optional[Sequence[int]] = None,
) -> ParamTree:
    """Quantize the Dense weights of a model (the §4.3 porting step).

    ``only_nodes`` restricts quantization to a subset — the paper isolates and
    quantizes a single hidden layer in §6.1.
    """
    x_scales = (calibrate_activation_scales(model, params, calibration, scheme)
                if calibration is not None else {})
    qmax = float(torch.iinfo(_int_dtype(scheme)).max)
    out: ParamTree = {}
    for node in model.graph.nodes:
        p = dict(params[node.uid])
        quantizable = isinstance(node.layer, Dense) and "w" in p
        selected = only_nodes is None or node.uid in only_nodes
        if quantizable and selected:
            w = p.pop("w")
            qt = quantize_tensor(w, scheme, per_channel=per_channel)
            p["qw"] = qt.q
            p["w_scale"] = qt.scale
            # Default activation scale assumes inputs in [-1, 1] (sensor
            # readings are normalized on the PLC before inference).
            p["x_scale"] = x_scales.get(
                node.uid,
                torch.tensor(1.0 / qmax, dtype=torch.float32, device=w.device))
        out[node.uid] = p
    return out


# ---------------------------------------------------------------------------
# Memory accounting (Table 2) and operation analysis (§6.1) — analytic,
# byte-exact reproductions of the paper's numbers.
# ---------------------------------------------------------------------------


def memory_report(in_features: int, units: int, scheme: str) -> Dict[str, int]:
    """Bytes for one dense layer under a quantization scheme (Table 2)."""
    if scheme == "REAL":
        return {
            "weights": in_features * units * 4,
            "biases": units * 4,
            "scaling_factors": 0,
            "total": in_features * units * 4 + units * 4,
        }
    itemsize = IEC_INT_TYPES[scheme].itemsize
    weights = in_features * units * itemsize
    biases = units * 4
    scales = (units + 1) * 4  # per-channel weight scales + activation scale
    return {
        "weights": weights,
        "biases": biases,
        "scaling_factors": scales,
        "total": weights + biases + scales,
    }


def op_counts(in_features: int, units: int, quantized: bool) -> Dict[str, int]:
    """§6.1 arithmetic-operation analysis for one dense layer evaluation."""
    if not quantized:
        return {
            "float_mul": in_features * units,
            "float_add": in_features * units + units,  # accumulate + bias
            "int_mul": 0,
            "int_add": 0,
        }
    return {
        "float_mul": in_features + units,  # activation quant + rescale
        "float_add": units,                # bias
        "int_mul": in_features * units,
        "int_add": in_features * units,
    }


def quantization_error_bound(scale: torch.Tensor) -> torch.Tensor:
    """Symmetric rounding error bound: |w - deq(q(w))| <= scale / 2."""
    return scale / 2.0
