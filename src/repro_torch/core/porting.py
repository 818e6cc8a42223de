"""Model porting methodology (§4.3) + BINARR/ARRBIN binary I/O, the
counterpart of ``repro.core.porting``.

The paper's end-to-end flow: collect data on the PLC (ARRBIN), train in an
established framework, extract weights/biases to binary files, statically
reconstruct the model in ICSML, load the binaries (BINARR), infer.

``arrbin``/``binarr`` write/read raw little-endian binary exactly like the ST
functions.  The files are byte-equal to the reference's, so a weight
directory written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.layers import Dense, Input
from repro_torch.core.model import Model, ParamTree, sequential
from repro_torch.device import Device, params_device, resolve_device


def _host(arr: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def arrbin(path: str, arr: Union[np.ndarray, torch.Tensor]) -> int:
    """ICSML.ARRBIN: dump an array's raw bytes to a binary file.

    Returns the number of bytes written (the ST function takes the byte count
    and ADR(...); we derive both from the array)."""
    data = np.ascontiguousarray(_host(arr))
    with open(path, "wb") as f:
        f.write(data.tobytes())
    return data.nbytes


def binarr(path: str, dtype: Union[np.dtype, str],
           shape: Sequence[int]) -> np.ndarray:
    """ICSML.BINARR: load raw binary data back into a (statically shaped) array."""
    dtype = np.dtype(dtype)
    expected = int(np.prod(shape)) * dtype.itemsize
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) != expected:
        raise ValueError(
            f"{path}: expected {expected} bytes for {tuple(shape)} {dtype}, "
            f"found {len(raw)}"
        )
    return np.frombuffer(raw, dtype=dtype).reshape(tuple(shape)).copy()


# ---------------------------------------------------------------------------
# Weight extraction + static reconstruction
# ---------------------------------------------------------------------------


def extract_mlp_weights(
    params: ParamTree, model: Model
) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Extract (W, b) pairs from a trained sequential model in schedule
    order, as host arrays."""
    out = []
    for node in model.graph.nodes:
        p = params[node.uid]
        if isinstance(node.layer, Dense):
            b = p.get("b")
            out.append((_host(p["w"]), None if b is None else _host(b)))
    return out


def export_weights(
    weights: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]], directory: str
) -> List[str]:
    """Write each layer's weights/biases to binary files (porting step 3)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, (w, b) in enumerate(weights):
        wp = os.path.join(directory, f"L{i}_weights.bin")
        arrbin(wp, w.astype(np.float32))
        paths.append(wp)
        if b is not None:
            bp = os.path.join(directory, f"L{i}_biases.bin")
            arrbin(bp, b.astype(np.float32))
            paths.append(bp)
    return paths


def build_mlp(
    layer_sizes: Sequence[int],
    input_size: int,
    activations: Sequence[str],
) -> Model:
    """Static reconstruction (porting step 4): declare layer sizes as
    constants, then build the array of layers.  Mirrors the paper's listing
    (L1_size, L1_weights[0..L1_size*input_size-1], dataMem construction)."""
    if len(activations) != len(layer_sizes):
        raise ValueError("need one activation per layer")
    layers = [Input()]
    for units, act in zip(layer_sizes, activations):
        layers.append(Dense(units=units, activation=act))
    return sequential(layers, (input_size,))


def load_mlp_params(model: Model, directory: str, *,
                    device: Device = "cuda") -> ParamTree:
    """Porting step 5: BINARR the weights/biases into the reconstructed
    model, as f32 tensors on ``device``."""
    dev = resolve_device(device)
    shapes = model.graph.infer_shapes(model.input_shape)
    params: ParamTree = {}
    dense_idx = 0
    for node in model.graph.nodes:
        if isinstance(node.layer, Dense):
            in_shape = (
                shapes[node.inputs[0]] if node.inputs else model.input_shape
            )
            w = binarr(
                os.path.join(directory, f"L{dense_idx}_weights.bin"),
                np.float32,
                (in_shape[0], node.layer.units),
            )
            p = {"w": torch.from_numpy(w).to(dev)}
            bpath = os.path.join(directory, f"L{dense_idx}_biases.bin")
            if os.path.exists(bpath):
                b = binarr(bpath, np.float32, (node.layer.units,))
                p["b"] = torch.from_numpy(b).to(dev)
            params[node.uid] = p
            dense_idx += 1
        else:
            params[node.uid] = {}
    return params


def port_mlp(
    trained_model: Model,
    trained_params: ParamTree,
    directory: str,
) -> Tuple[Model, ParamTree]:
    """The full §4.3 round trip: extract → export → reconstruct → load, onto
    the trained params' device.

    Returns a *new* Model + params whose inference is bit-identical to the
    trained one — the paper's 'no sacrifice in inference accuracy' claim."""
    weights = extract_mlp_weights(trained_params, trained_model)
    export_weights(weights, directory)
    sizes, acts = [], []
    for node in trained_model.graph.nodes:
        if isinstance(node.layer, Dense):
            sizes.append(node.layer.units)
            acts.append(node.layer.activation)
    ported = build_mlp(sizes, trained_model.input_shape[0], acts)
    return ported, load_mlp_params(ported, directory,
                                   device=params_device(trained_params))
