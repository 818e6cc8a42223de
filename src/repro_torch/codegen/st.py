"""IEC 61131-3 Structured Text emitter: trained detector -> FUNCTION_BLOCK,
the counterpart of ``repro.codegen.st``.

The paper's headline artifact is *native inference on the PLC*: the trained,
quantized model compiled to IEC 61131-3 code a controller executes in its
scan cycle.  :func:`export_st` is that porting step for any all-Dense stack
served by the fleet engines — it emits one self-contained ``FUNCTION_BLOCK``
(no external libraries, weights as ``VAR CONSTANT`` arrays) in one of two
schemes, inferred from the params:

* **REAL** — float params (``w``/``b``): f32 matvec with sequential
  accumulation.  A PLC's REAL is IEEE binary32, so the exported arithmetic
  matches the served forward to reassociation error only (the oracle
  reduces in a different order); exports verify to an epsilon, not
  bit-exactly.
* **SINT** — §6.1-quantized params (``qw`` int8 / ``w_scale`` / ``x_scale``):
  activation quantization with the oracle's exact clip rails (round
  half-to-even, clip to ±127 — the rail guard fires at ``|t| >= 127.0``,
  which decides identically to round-then-clip), int8 weights in
  ``ARRAY OF SINT``, DINT (int32) accumulation, then the per-layer
  f32 requantize ``DINT_TO_REAL(acc) * scale[i] + bias[i]`` with the
  combined per-channel scale precomputed in f32 exactly as
  ``kernels/ops`` stages it.  Integer products and f32 rescale are
  order-independent, so SINT exports are **bit-exact** against
  ``codegen.verify.numpy_mlp_ref`` — the property ``codegen.verify`` and
  the test suite enforce on every export.

INT/DINT schemes are rejected: the reference emulates their accumulation
in f32, which a PLC's genuine integer arithmetic would *not* reproduce —
exporting them would emit code that is faithful to neither side.

The verdict epilogue is the head's business: ``export_st`` hands a
:class:`STWriter` + :class:`STContext` to ``head.st_epilogue`` (see
``sim.heads``), which declares the verdict ``VAR_OUTPUT``s (classifier:
``PRED``/``CONF``; score heads: ``PRED``/``SCORE``/``THRESHOLD`` with the
calibrated cutoff baked in as a constant).  ``head=None`` exports the bare
body (``Y`` only) — the differential-fuzz harness uses that form.

Ingest normalization can be baked into the block (``normalize=(mean, std)``
per feature): the block then consumes the *raw* ring window exactly as the
serving engines do, applying the same two f32 ops per element the engines'
host-side ingest applies.

Parameters are torch tensors on any device; :func:`export_st` reads each
to the host once, in its stored dtype (bfloat16 as f32), and emits from
numpy.  The text is byte-equal to the reference's export of the same
weights except for the module its first comment names as its author.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.layers import Dense, Input
from repro_torch.kernels.ops import dense_stack


class STExportError(ValueError):
    """The model/params/head combination cannot be exported to ST."""


# Activations expressible in the emitted subset.  SINT layers additionally
# require the activation to be exact in one f32 op (MAX / identity) so the
# bit-exactness contract survives; sigmoid/tanh ride the REAL path only and
# verify to epsilon like the rest of it.
_SINT_ACTS = ("relu", "linear")
_REAL_ACTS = ("relu", "linear", "sigmoid", "tanh")

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def format_real(v: float) -> str:
    """An ST REAL literal that parses back to exactly the f32 ``v``: the
    shortest float64 repr of the f32 (exact, since f32 -> f64 is exact and
    the emulator/compiler parses to f64 then rounds to f32)."""
    f = float(np.float32(v))
    if not np.isfinite(f):
        raise STExportError(f"non-finite REAL constant {v!r}")
    s = repr(f)
    if "e" in s or "E" in s:
        mant, _, ex = s.replace("E", "e").partition("e")
        if "." not in mant:
            mant += ".0"
        return f"{mant}E{int(ex):+d}"
    if "." not in s:
        s += ".0"
    return s


@dataclasses.dataclass(frozen=True)
class STContext:
    """What a head's ST epilogue may reference in the surrounding block."""

    y: str                  # model-output REAL array (size n_outputs)
    x: str                  # model-input view: normalized window when
    #                         normalization is baked, else the raw input
    n_outputs: int
    in_width: int           # model input width the body consumed
    window_width: int       # full FB input width (>= in_width for forecast)
    n_features: int


class STWriter:
    """Accumulates declarations + body statements, renders one block.

    Declarations are keyed by (upper-cased) name: ``var`` deduplicates
    (emitter and head share scratch like ``I``/``T``), everything else
    rejects collisions.  Body lines are plain pre-indented statements.
    """

    def __init__(self, name: str):
        if not _NAME_RE.match(name):
            raise STExportError(f"invalid ST identifier {name!r}")
        self.name = name.upper()
        self._sections: Dict[str, List[Tuple[str, str, Optional[int],
                                             Optional[object]]]] = {
            "VAR_INPUT": [], "VAR_OUTPUT": [], "VAR": [], "CONST": []}
        self._names: Dict[str, str] = {}
        self.body: List[str] = []

    def _declare(self, section, name, base, size, init=None):
        name = name.upper()
        if not _NAME_RE.match(name):
            raise STExportError(f"invalid ST identifier {name!r}")
        prior = self._names.get(name)
        if prior is not None:
            if section == "VAR" and prior == ("VAR", base, size):
                return name                       # shared scratch
            raise STExportError(f"duplicate ST declaration {name}")
        self._names[name] = (section, base, size) if section == "VAR" \
            else section
        self._sections[section].append((name, base, size, init))
        return name

    def input(self, name, base, size=None):
        return self._declare("VAR_INPUT", name, base, size)

    def output(self, name, base, size=None):
        return self._declare("VAR_OUTPUT", name, base, size)

    def var(self, name, base, size=None):
        return self._declare("VAR", name, base, size)

    def const(self, name, base, value):
        size = len(value) if isinstance(value, (list, tuple)) else None
        return self._declare("CONST", name, base, size, value)

    def line(self, stmt: str) -> None:
        self.body.append(stmt)

    def comment(self, text: str) -> None:
        self.body.append(f"(* {text} *)")

    @staticmethod
    def real(v: float) -> str:
        return format_real(v)

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def _literal(base: str, v) -> str:
        return format_real(v) if base == "REAL" else str(int(v))

    def _render_decl(self, name, base, size, init) -> List[str]:
        if size is None:
            head = f"    {name} : {base}"
            if init is not None:
                head += f" := {self._literal(base, init)}"
            return [head + ";"]
        head = f"    {name} : ARRAY[0..{size - 1}] OF {base}"
        if init is None:
            return [head + ";"]
        toks = [self._literal(base, v) for v in init]
        lines = [head + " := ["]
        cur = "       "
        for i, t in enumerate(toks):
            piece = t + ("," if i < len(toks) - 1 else "")
            if len(cur) + len(piece) + 1 > 78:
                lines.append(cur)
                cur = "       "
            cur += " " + piece
        lines.append(cur)
        lines.append("    ];")
        return lines

    def render(self) -> str:
        out = [f"FUNCTION_BLOCK {self.name}"]
        for section, keyword in (("VAR_INPUT", "VAR_INPUT"),
                                 ("VAR_OUTPUT", "VAR_OUTPUT"),
                                 ("VAR", "VAR"),
                                 ("CONST", "VAR CONSTANT")):
            decls = self._sections[section]
            if not decls:
                continue
            out.append(keyword)
            for d in decls:
                out.extend(self._render_decl(*d))
            out.append("END_VAR")
        out.append("")
        out.extend(f"    {s}" if s else "" for s in self.body)
        out.append("END_FUNCTION_BLOCK")
        return "\n".join(out) + "\n"


@dataclasses.dataclass(frozen=True)
class STExport:
    """One exported block plus the contract needed to verify/serve it."""

    text: str
    name: str
    scheme: str                       # "REAL" | "SINT"
    head_name: Optional[str]          # None for a bare-body export
    verdict_outputs: Tuple[str, ...]  # head VAR_OUTPUTs ("Y" always exists)
    window: int                       # ring readings per verdict window
    window_width: int                 # FB input width (window * n_features)
    in_width: int                     # model input width
    n_outputs: int
    n_features: int
    threshold: Optional[float]        # f32-snapped baked cutoff (score heads)
    normalize: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]]


def _stack_scheme(stack) -> str:
    schemes = []
    for i, (p, _) in enumerate(stack):
        if "qw" in p:
            qw = np.asarray(p["qw"])
            if qw.dtype != np.int8:
                raise STExportError(
                    f"layer {i} is {qw.dtype.name}-quantized: the "
                    "reference emulates INT/DINT accumulation in f32, which "
                    "genuine PLC integer arithmetic would not reproduce — "
                    "export SINT or REAL")
            if "w_scale" not in p or "x_scale" not in p:
                raise STExportError(
                    f"layer {i} quantized params lack w_scale/x_scale")
            schemes.append("SINT")
        elif "w" in p:
            schemes.append("REAL")
        else:
            raise STExportError(f"layer {i} has neither 'w' nor 'qw'")
    if len(set(schemes)) != 1:
        raise STExportError(
            f"mixed-scheme stacks are not exportable (got {schemes}); "
            "quantize every layer or none")
    return schemes[0]


def _host_leaf(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.cpu().numpy()
    return v if v is None else np.asarray(v)


def _host_stack(stack) -> list:
    """A layer stack with every parameter read to the host once."""
    return [({k: _host_leaf(v) for k, v in p.items()}, act)
            for p, act in stack]


def _emit_activation(w: STWriter, out: str, i: str, act: str,
                     value: str) -> None:
    """``out[i] := act(value)`` where ``value`` is a REAL scratch var."""
    if act == "relu":
        w.line(f"{out}[{i}] := MAX({value}, 0.0);")
    elif act == "linear":
        w.line(f"{out}[{i}] := {value};")
    elif act == "sigmoid":
        # Overflow-stable split: never exponentiates a positive argument.
        w.var("E", "REAL")
        w.line(f"IF {value} >= 0.0 THEN")
        w.line(f"    {out}[{i}] := 1.0 / (1.0 + EXP(-{value}));")
        w.line("ELSE")
        w.line(f"    E := EXP({value});")
        w.line(f"    {out}[{i}] := E / (1.0 + E);")
        w.line("END_IF;")
    elif act == "tanh":
        # tanh(t) = 1 - 2/(exp(2t) + 1), reflected to keep EXP's argument
        # non-positive.
        w.var("E", "REAL")
        w.line(f"IF {value} >= 0.0 THEN")
        w.line(f"    E := EXP(-2.0 * {value});")
        w.line(f"    {out}[{i}] := 1.0 - 2.0 * E / (1.0 + E);")
        w.line("ELSE")
        w.line(f"    E := EXP(2.0 * {value});")
        w.line(f"    {out}[{i}] := 2.0 * E / (1.0 + E) - 1.0;")
        w.line("END_IF;")
    else:  # pragma: no cover - guarded by the scheme/activation check
        raise STExportError(f"activation {act!r} is not exportable")


def export_st(model, params, head=None, *, name: str = "DETECTOR",
              normalize: Optional[Tuple[Sequence[float],
                                        Sequence[float]]] = None,
              n_features: int = 2) -> STExport:
    """Emit one self-contained IEC 61131-3 FUNCTION_BLOCK for a trained
    (optionally §6.1-quantized) all-Dense detector.

    ``head`` contributes the verdict epilogue (``sim.heads`` —
    ``st_epilogue``); ``None`` exports the bare body with only the raw
    model-output array ``Y``.  ``normalize=(mean, std)`` (per-feature) bakes
    the engines' ingest normalization into the block so it consumes raw
    sensor windows.  The emitted text is deterministic: same model, params
    and head -> identical bytes, equal to the reference's.
    """
    if not all(isinstance(n.layer, (Input, Dense))
               for n in model.graph.nodes):
        raise STExportError(
            "only all-Dense chain models are exportable to ST (found a "
            "non-Dense layer in the graph)")
    stack = _host_stack(dense_stack(model, params))
    if not stack:
        raise STExportError("model has no Dense layers")
    scheme = _stack_scheme(stack)
    acts_ok = _SINT_ACTS if scheme == "SINT" else _REAL_ACTS
    for i, (_, act) in enumerate(stack):
        if act not in acts_ok:
            raise STExportError(
                f"layer {i} activation {act!r} is not exportable under "
                f"{scheme} (supported: {acts_ok})")

    weights = [np.asarray(p["qw" if scheme == "SINT" else "w"])
               for p, _ in stack]
    for i, wt in enumerate(weights):
        if wt.ndim != 2:
            raise STExportError(f"layer {i} weight is not 2-D")
    in_width = weights[0].shape[0]
    n_outputs = weights[-1].shape[1]
    for i in range(1, len(weights)):
        if weights[i].shape[0] != weights[i - 1].shape[1]:
            raise STExportError(
                f"layer {i} input width {weights[i].shape[0]} does not "
                f"chain from layer {i - 1} output {weights[i - 1].shape[1]}")

    if head is not None:
        try:
            head.validate(in_width, n_outputs)
            window = head.ring_window(in_width, n_features)
        except STExportError:
            raise
        except ValueError as e:    # an uncalibrated or misfit head
            raise STExportError(str(e)) from e
    else:
        if in_width % n_features:
            raise STExportError(
                f"model input {in_width} is not a whole number of "
                f"{n_features}-feature readings")
        window = in_width // n_features
    window_width = window * n_features

    w = STWriter(name)
    w.comment(f"auto-generated by repro_torch.codegen.st - scheme {scheme}, "
              f"head {head.name if head is not None else 'none'}")
    w.comment(f"window: {window} readings x {n_features} features "
              f"(oldest first, features interleaved per reading)")
    w.input("X", "REAL", window_width)
    w.output("Y", "REAL", n_outputs)
    w.var("I", "DINT")
    w.var("J", "DINT")
    w.var("T", "REAL")

    # -- ingest normalization (optional, baked) -----------------------------
    if normalize is not None:
        mean, std = normalize
        if len(mean) != n_features or len(std) != n_features:
            raise STExportError(
                f"normalize needs {n_features} per-feature means/stds")
        model_x = w.var("NX", "REAL", window_width)
        w.const("NMEAN", "REAL", [float(np.float32(v)) for v in mean])
        w.const("NSTD", "REAL", [float(np.float32(v)) for v in std])
        w.comment("ingest normalization: (x - mean) / std per feature")
        w.line(f"FOR I := 0 TO {window - 1} DO")
        w.line(f"    FOR J := 0 TO {n_features - 1} DO")
        w.line(f"        NX[I * {n_features} + J] := "
               f"(X[I * {n_features} + J] - NMEAN[J]) / NSTD[J];")
        w.line("    END_FOR;")
        w.line("END_FOR;")
        norm_tuple = (tuple(float(np.float32(v)) for v in mean),
                      tuple(float(np.float32(v)) for v in std))
    else:
        model_x = "X"
        norm_tuple = None

    # -- dense body ---------------------------------------------------------
    if scheme == "SINT":
        w.var("XQ", "SINT", max(wt.shape[0] for wt in weights))
        w.var("ACC", "DINT")
    cur = model_x
    for k, ((p, act), wt) in enumerate(zip(stack, weights)):
        kk, nn = wt.shape
        out = "Y" if k == len(stack) - 1 else w.var(f"A{k + 1}", "REAL", nn)
        wname = w.const(f"W{k}", "SINT" if scheme == "SINT" else "REAL",
                        [v for v in wt.flatten().tolist()])
        b = p.get("b")
        bias = np.zeros(nn, np.float32) if b is None else np.asarray(b)
        bname = w.const(f"B{k}", "REAL",
                        [float(np.float32(v)) for v in bias])
        w.comment(f"layer {k}: {kk} -> {nn}, {act}")
        if scheme == "SINT":
            xs = np.float32(np.asarray(p["x_scale"]))
            combined = (xs * np.asarray(p["w_scale"], np.float32)
                        ).astype(np.float32)
            combined = np.broadcast_to(combined, (nn,))
            sname = w.const(f"S{k}", "REAL",
                            [float(v) for v in combined.tolist()])
            qname = w.const(f"Q{k}", "REAL", float(xs))
            w.line(f"FOR J := 0 TO {kk - 1} DO")
            w.line(f"    T := {cur}[J] / {qname};")
            w.line("    IF T >= 127.0 THEN")
            w.line("        XQ[J] := 127;")
            w.line("    ELSIF T <= -127.0 THEN")
            w.line("        XQ[J] := -127;")
            w.line("    ELSE")
            w.line("        XQ[J] := REAL_TO_SINT(T);")
            w.line("    END_IF;")
            w.line("END_FOR;")
            w.line(f"FOR I := 0 TO {nn - 1} DO")
            w.line("    ACC := 0;")
            w.line(f"    FOR J := 0 TO {kk - 1} DO")
            w.line(f"        ACC := ACC + SINT_TO_DINT(XQ[J]) * "
                   f"SINT_TO_DINT({wname}[J * {nn} + I]);")
            w.line("    END_FOR;")
            w.line(f"    T := DINT_TO_REAL(ACC) * {sname}[I] + {bname}[I];")
            _emit_activation(w, out, "I", act, "T")
            w.line("END_FOR;")
        else:
            w.line(f"FOR I := 0 TO {nn - 1} DO")
            w.line("    T := 0.0;")
            w.line(f"    FOR J := 0 TO {kk - 1} DO")
            w.line(f"        T := T + {cur}[J] * {wname}[J * {nn} + I];")
            w.line("    END_FOR;")
            w.line(f"    T := T + {bname}[I];")
            _emit_activation(w, out, "I", act, "T")
            w.line("END_FOR;")
        cur = out

    # -- verdict epilogue ---------------------------------------------------
    threshold = None
    verdict_outputs: Tuple[str, ...] = ()
    head_name = None
    if head is not None:
        ctx = STContext(y="Y", x=model_x, n_outputs=n_outputs,
                        in_width=in_width, window_width=window_width,
                        n_features=n_features)
        head.st_epilogue(w, ctx)
        verdict_outputs = tuple(head.st_verdict_outputs())
        head_name = head.name
        thr = getattr(head, "threshold", None)
        if thr is not None:
            threshold = float(np.float32(thr))

    return STExport(
        text=w.render(), name=w.name, scheme=scheme, head_name=head_name,
        verdict_outputs=verdict_outputs, window=window,
        window_width=window_width, in_width=in_width, n_outputs=n_outputs,
        n_features=n_features, threshold=threshold, normalize=norm_tuple)
