"""Detector heads: what a detection workload computes *after* the MLP body.

``repro.sim.heads`` in PyTorch: each head's training objective, its
serving epilogues and its Structured Text export hooks.

* :class:`ClassifierHead` — the §7 classifier: sparse-CE loss over labeled
  windows, verdict = argmax class with its softmax probability.
* :class:`ReconstructionHead` — autoencoder: anomaly score = per-window mean
  squared reconstruction error; trained on benign windows only.
* :class:`MarginHead` — one-class margin: score = mean squared distance of
  the embedding from a fixed benign ``center``.
* :class:`ForecastHead` — next-step prediction: the model maps the window's
  first ``W - 1`` readings to the ``W``-th; score = squared forecast error.

A head contributes its training objective (``loss``, and ``metric``, the
model-selection score that checkpoint-best maximizes: differentiable torch
ops on the outputs' device, which ``sim.detector``'s trainers call on batched
model outputs), the window-geometry contract (``ring_window`` /
``model_input_size``), the device-side model-input view (``prepare``) and
verdict reduction (``epilogue``, torch ops inside the engine's step), and the
host-side verdict (``host_verdicts``, numpy).  Score heads also own their
threshold calibration (``calibrate``, the conservative quantile) and the
streaming recalibration state (``calib_state`` / ``calib_update`` on the
device, ``streaming_threshold`` on the host).  Host-side code is the
reference's numpy, so verdicts agree bit for bit on equal step outputs.

For the IEC 61131-3 export (``repro_torch.codegen.st``) a head writes the
verdict epilogue of the emitted ``FUNCTION_BLOCK`` (``st_epilogue``,
``st_score``) and names its verdict outputs (``st_verdict_outputs``); the
text is the reference's, statement for statement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import to_device


def softmax_np(logits: np.ndarray) -> np.ndarray:
    """Batched-stable host softmax: subtracts the per-row max along the last
    axis before exponentiating, so rows of extreme logits never overflow
    ``exp``."""
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def conservative_quantile(scores: np.ndarray, target_fpr: float) -> float:
    """The ``(1 - target_fpr)`` empirical quantile, rounded UP to an actual
    order statistic (``method="higher"``), so ``mean(scores > q)`` — the
    realized FPR on the calibration scores themselves — is ≤ ``target_fpr``
    even on small calibration sets."""
    return float(np.quantile(np.asarray(scores, np.float64), 1.0 - target_fpr,
                             method="higher"))


class DetectorHead:
    """Base: the loss / device epilogue / host verdict of one workload."""

    name: str = "?"

    def loss(self, outputs: torch.Tensor, x: torch.Tensor,
             y: Optional[torch.Tensor]) -> torch.Tensor:
        """Training objective over batched model outputs."""
        raise NotImplementedError

    def metric(self, outputs: torch.Tensor, x: torch.Tensor,
               y: Optional[torch.Tensor]) -> torch.Tensor:
        """Scalar model-selection metric — greater is better (checkpoint-best
        and early stopping in the head-generic trainer key on it)."""
        raise NotImplementedError

    def validate(self, input_size: int, n_outputs: int) -> None:
        """Raise early (engine construction) if the model can't carry this
        head; the default accepts any output width."""

    def ring_window(self, input_size: int, n_features: int) -> int:
        """Ring readings per verdict window for a model of ``input_size``:
        by default the window IS the model input."""
        if input_size % n_features:
            raise ValueError(
                f"model input {input_size} is not a whole number of "
                f"{n_features}-feature readings")
        return input_size // n_features

    def model_input_size(self, window: int, n_features: int) -> int:
        """Model input width for a ``window``-reading ring — the inverse of
        :meth:`ring_window`."""
        return window * n_features

    def prepare(self, win: torch.Tensor) -> torch.Tensor:
        """Device-side model-input view of the batched ``(S, window x F)``
        window.  The default feeds the whole window."""
        return win

    def epilogue(self, win: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Device-side reduction from raw model outputs to the per-stream
        verdict payload."""
        raise NotImplementedError

    def kernel_epilogue(self) -> Optional[Tuple[str, str]]:
        """The head's in-kernel epilogue spec for the grouped megakernel, or
        None when the engine must serve this head per group.  The spec is
        ``(payload, target)``: ``("logits", "none")`` passes the final
        activations through; ``("mse", "window" | "tail" | "center")``
        reduces to the mean squared error against the whole window, its
        newest reading, or a fixed center row.  Custom heads opt in."""
        return None

    def host_verdicts(self, out: np.ndarray,
                      threshold: Optional[float] = None) -> Tuple[
            np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
            Optional[float]]:
        """Step output -> (pred, prob|None, score|None, threshold|None).
        ``threshold`` overrides the head's own calibrated cutoff (the
        engine's live threshold)."""
        raise NotImplementedError

    # -- IEC 61131-3 Structured Text export (repro_torch.codegen.st) --------
    #
    # The writer is duck-typed (codegen.st.STWriter) so this module never
    # imports the codegen package; ``ctx`` is a codegen.st.STContext carrying
    # the array names and widths of the surrounding block.

    def st_verdict_outputs(self) -> Tuple[str, ...]:
        """Names of the VAR_OUTPUTs the head's ST epilogue produces, in
        Verdict-field order."""
        raise NotImplementedError(
            f"{type(self).__name__} has no Structured Text export epilogue")

    def st_epilogue(self, w, ctx) -> None:
        """Write the verdict epilogue into an ST writer: declare the verdict
        VAR_OUTPUTs and emit the statements computing them from the model
        output array ``ctx.y`` (and the model-input view ``ctx.x``)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no Structured Text export epilogue")


@dataclasses.dataclass(frozen=True)
class ClassifierHead(DetectorHead):
    """Supervised classifier: CE loss, argmax verdict (§7's head)."""

    name: str = "classifier"

    def loss(self, outputs, x, y):
        logz = torch.logsumexp(outputs, dim=-1)
        gold = torch.gather(outputs, -1, y[:, None].long())[:, 0]
        return torch.mean(logz - gold)

    def metric(self, outputs, x, y):
        # The reference's f32 mean of the hits is their count times the f32
        # reciprocal of the batch (XLA's form of the division), which can
        # sit an ulp from count / n: take it the same way, so accuracies
        # agree bit for bit.
        hits = torch.sum(torch.argmax(outputs, dim=-1) == y,
                         dtype=torch.float32)
        return hits * float(np.float32(1) / np.float32(len(y)))

    def epilogue(self, win, out):
        return out                      # the logits ARE the verdict payload

    def kernel_epilogue(self):
        # Pass-through logits; a final-layer softmax is masked in-kernel to
        # the group's true class count.
        return ("logits", "none")

    def host_verdicts(self, out, threshold=None):
        pred = out.argmax(axis=-1)
        prob = softmax_np(out)[np.arange(len(out)), pred]
        return pred.astype(np.int64), prob, None, None

    def st_verdict_outputs(self):
        return ("PRED", "CONF")

    def st_epilogue(self, w, ctx):
        # Argmax with strict `>` keeps the FIRST maximum — np.argmax's tie
        # rule — and the softmax probability of the argmax class collapses to
        # 1/sum(exp(y_i - max)): exp(0) = 1.0 exactly, so the winning term
        # needs no batch-varying index.
        w.output("PRED", "DINT")
        w.output("CONF", "REAL")
        w.var("I", "DINT")
        w.var("BEST", "REAL")
        w.var("ESUM", "REAL")
        w.comment("verdict: argmax class + softmax confidence of that class")
        w.line(f"BEST := {ctx.y}[0];")
        w.line("PRED := 0;")
        w.line(f"FOR I := 1 TO {ctx.n_outputs - 1} DO")
        w.line(f"    IF {ctx.y}[I] > BEST THEN")
        w.line(f"        BEST := {ctx.y}[I];")
        w.line("        PRED := I;")
        w.line("    END_IF;")
        w.line("END_FOR;")
        w.line("ESUM := 0.0;")
        w.line(f"FOR I := 0 TO {ctx.n_outputs - 1} DO")
        w.line(f"    ESUM := ESUM + EXP({ctx.y}[I] - BEST);")
        w.line("END_FOR;")
        w.line("CONF := 1.0 / ESUM;")


@dataclasses.dataclass(frozen=True)
class ScoreHead(DetectorHead):
    """Base for score-vs-threshold heads (every unsupervised workload).

    Subclasses define :meth:`batch_scores`; the base gives the training
    objective (mean score on benign windows), the device epilogue ((S, 1)
    scores), the host verdict (strict ``score > threshold``), conservative
    FPR calibration and streaming recalibration.
    ``threshold`` is None until calibrated; serving requires it.
    """

    threshold: Optional[float] = None
    target_fpr: Optional[float] = None
    name: str = "score"

    def batch_scores(self, outputs: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
        """Per-window anomaly scores ``(B,)`` from batched model outputs
        (``x`` is the full window batch, before :meth:`prepare`)."""
        raise NotImplementedError

    def loss(self, outputs, x, y):
        return torch.mean(self.batch_scores(outputs, x))

    def metric(self, outputs, x, y):
        # Lower anomaly score on benign data is better; the trainer maximizes.
        return -self.loss(outputs, x, y)

    def validate(self, input_size: int, n_outputs: int) -> None:
        if self.threshold is None:
            raise ValueError(
                f"{type(self).__name__} has no threshold; calibrate it on "
                "held-out normal traces first (head.calibrate)")

    def epilogue(self, win, out):
        # On-device score reduction: one float per stream leaves the device.
        return self.batch_scores(out, win)[:, None]

    def calibrate(self, normal_scores: np.ndarray,
                  target_fpr: float) -> "ScoreHead":
        """A new head whose threshold realizes at most ``target_fpr`` false
        positives on the given held-out *normal* window scores."""
        if not 0.0 < target_fpr < 1.0:
            raise ValueError(f"target_fpr must be in (0, 1), got {target_fpr}")
        scores = np.asarray(normal_scores, np.float64)
        if scores.size == 0:
            raise ValueError("cannot calibrate on zero normal scores")
        return dataclasses.replace(
            self, threshold=conservative_quantile(scores, target_fpr),
            target_fpr=target_fpr)

    def host_verdicts(self, out, threshold=None):
        thr = self.threshold if threshold is None else threshold
        if thr is None:
            raise ValueError(
                f"{type(self).__name__} has no threshold; calibrate it on "
                "held-out normal traces first (head.calibrate)")
        score = out[:, 0] if out.ndim == 2 else out
        pred = (score > thr).astype(np.int64)
        return pred, None, score, thr

    def st_verdict_outputs(self):
        return ("PRED", "SCORE", "THRESHOLD")

    def st_score(self, w, ctx) -> None:
        """Write the statements assigning the head's anomaly score to the
        REAL output ``SCORE`` — sequential f32 accumulation, the ST-side
        contract the verification oracle replays."""
        raise NotImplementedError

    def st_epilogue(self, w, ctx):
        if self.threshold is None:
            raise ValueError(
                f"{type(self).__name__} has no threshold; calibrate before "
                "exporting to Structured Text (the cutoff is baked into the "
                "block as a constant)")
        w.output("SCORE", "REAL")
        w.output("PRED", "DINT")
        w.output("THRESHOLD", "REAL")
        # The calibrated cutoff is an actual f32 calibration score, so
        # snapping to f32 is exact and the strict REAL compare decides as the
        # engine's float64 `score > threshold` does.
        w.const("THR", "REAL", float(np.float32(self.threshold)))
        self.st_score(w, ctx)
        w.comment("verdict: strict score > calibrated threshold")
        w.line("THRESHOLD := THR;")
        w.line("IF SCORE > THR THEN")
        w.line("    PRED := 1;")
        w.line("ELSE")
        w.line("    PRED := 0;")
        w.line("END_IF;")

    # -- streaming recalibration (online drift adaptation) -----------------

    def calib_state(self, n_streams: int, capacity: int,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed per-stream rolling calibration state: a ``(n_streams,
        capacity)`` ring of admitted scores plus ``(n_streams,)`` admission
        counts."""
        return (torch.zeros((n_streams, capacity), dtype=torch.float32,
                            device=device),
                torch.zeros((n_streams,), dtype=torch.int32, device=device))

    def calib_update(self, ring: torch.Tensor, counts: torch.Tensor,
                     scores: torch.Tensor, threshold: float,
                     headroom: float) -> None:
        """Device-side state transition, in place: each stream's score enters
        its rolling ring iff it is at most ``headroom`` times the live
        ``threshold`` (scores beyond it are treated as attacks and never
        poison the calibration state)."""
        s = scores[:, 0] if scores.ndim == 2 else scores
        # The reference admits against f32(headroom) * f32(threshold), one
        # f32 multiply; numpy does the same multiply on the host.
        limit = float(np.float32(headroom) * np.float32(threshold))
        admit = s <= limit
        pos = (counts % ring.shape[1]).long()
        rows = torch.arange(ring.shape[0], device=ring.device)
        ring[rows, pos] = torch.where(admit, s, ring[rows, pos])
        counts += admit.to(counts.dtype)

    def streaming_scores(self, ring, counts) -> np.ndarray:
        """Host-side: the pooled valid scores in a gathered calibration
        state (slot ``j`` of a stream holds a real score iff ``j < count``)."""
        ring = np.asarray(ring)
        counts = np.asarray(counts)
        valid = np.arange(ring.shape[1])[None, :] < counts[:, None]
        return ring[valid]

    def streaming_threshold(self, ring, counts, *,
                            min_count: int = 1) -> Optional[float]:
        """Host-side: the conservative ``(1 - target_fpr)`` quantile of the
        pooled valid ring scores; None (leave the live threshold alone)
        until ``min_count`` scores have been admitted fleet-wide."""
        if self.target_fpr is None:
            raise ValueError(
                f"{type(self).__name__} has no target_fpr; calibrate via "
                "head.calibrate (or construct with target_fpr=) before "
                "streaming recalibration")
        scores = self.streaming_scores(ring, counts)
        if scores.size < max(min_count, 1):
            return None
        return conservative_quantile(scores, self.target_fpr)


@dataclasses.dataclass(frozen=True)
class ReconstructionHead(ScoreHead):
    """Unsupervised autoencoder: anomaly score = per-window mean squared
    reconstruction error, verdict = score over the calibrated threshold."""

    name: str = "reconstruction"

    def validate(self, input_size: int, n_outputs: int) -> None:
        if n_outputs != input_size:
            raise ValueError(
                f"ReconstructionHead needs an autoencoder whose output width "
                f"({n_outputs}) equals its input width ({input_size})")
        super().validate(input_size, n_outputs)

    def batch_scores(self, outputs, x):
        return torch.mean(torch.square(outputs - x), dim=-1)

    def kernel_epilogue(self):
        return ("mse", "window")

    def scores(self, recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Per-window anomaly scores from batched reconstructions."""
        return self.batch_scores(recon, x)

    def st_score(self, w, ctx):
        w.var("I", "DINT")
        w.var("T", "REAL")
        w.comment("anomaly score: mean squared reconstruction error")
        w.line("SCORE := 0.0;")
        w.line(f"FOR I := 0 TO {ctx.n_outputs - 1} DO")
        w.line(f"    T := {ctx.y}[I] - {ctx.x}[I];")
        w.line("    SCORE := SCORE + T * T;")
        w.line("END_FOR;")
        w.line(f"SCORE := SCORE / {w.real(float(ctx.n_outputs))};")


@dataclasses.dataclass(frozen=True)
class MarginHead(ScoreHead):
    """Unsupervised one-class margin (Deep-SVDD-style): anomaly score = mean
    squared distance of the embedding from the benign ``center``."""

    center: Optional[Tuple[float, ...]] = None
    name: str = "margin"
    # The center row on each device it was asked for, uploaded once.
    _centers: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def _center(self, device: torch.device = torch.device("cpu")
                ) -> torch.Tensor:
        """The center as an f32 row on ``device``, uploaded on first use."""
        center = self._centers.get(device)
        if center is None:
            center = self._centers[device] = to_device(
                np.asarray(self.center, np.float32), device)
        return center

    def validate(self, input_size: int, n_outputs: int) -> None:
        if self.center is None:
            raise ValueError(
                "MarginHead has no center; fit one on benign windows first")
        if len(self.center) != n_outputs:
            raise ValueError(
                f"MarginHead center has {len(self.center)} dims but the "
                f"model embeds into {n_outputs}")
        super().validate(input_size, n_outputs)

    def batch_scores(self, outputs, x):
        return torch.mean(torch.square(outputs - self._center(outputs.device)),
                          dim=-1)

    def kernel_epilogue(self):
        return ("mse", "center")

    def st_score(self, w, ctx):
        w.var("I", "DINT")
        w.var("T", "REAL")
        w.const("CENTER", "REAL",
                [float(np.float32(c)) for c in self.center])
        w.comment("anomaly score: mean squared distance from the benign "
                  "center")
        w.line("SCORE := 0.0;")
        w.line(f"FOR I := 0 TO {ctx.n_outputs - 1} DO")
        w.line(f"    T := {ctx.y}[I] - CENTER[I];")
        w.line("    SCORE := SCORE + T * T;")
        w.line("END_FOR;")
        w.line(f"SCORE := SCORE / {w.real(float(ctx.n_outputs))};")


@dataclasses.dataclass(frozen=True)
class ForecastHead(ScoreHead):
    """Unsupervised next-step prediction: the model maps the window's first
    ``W - 1`` readings to a forecast of the ``W``-th; the score is the mean
    squared forecast error against the reading that arrived.  The ring holds
    one more reading than the model eats (:meth:`ring_window`), and
    :meth:`prepare` slices the model input off the front of each window."""

    n_features: int = 2
    name: str = "forecast"

    def ring_window(self, input_size: int, n_features: int) -> int:
        if n_features != self.n_features:
            raise ValueError(
                f"ForecastHead was built for {self.n_features} features, "
                f"engine has {n_features}")
        if input_size % n_features:
            raise ValueError(
                f"forecast model input {input_size} is not a whole number "
                f"of {n_features}-feature readings")
        return input_size // n_features + 1

    def model_input_size(self, window: int, n_features: int) -> int:
        return (window - 1) * n_features

    def prepare(self, win):
        return win[..., :-self.n_features]

    def validate(self, input_size: int, n_outputs: int) -> None:
        if n_outputs != self.n_features:
            raise ValueError(
                f"ForecastHead predicts one {self.n_features}-feature "
                f"reading but the model outputs {n_outputs}")
        super().validate(input_size, n_outputs)

    def batch_scores(self, outputs, x):
        # x is the FULL window batch; the target is its last reading.
        return torch.mean(torch.square(outputs - x[..., -self.n_features:]),
                          dim=-1)

    def kernel_epilogue(self):
        # The megakernel feeds the FULL window and zero-pads the model's
        # weight rows past its true input width, so prepare()'s slice is
        # subsumed; the target is the window's newest reading.
        return ("mse", "tail")

    def st_score(self, w, ctx):
        # ctx.x is the FULL window array (the block keeps the extra ring
        # reading); the forecast target is its last reading, starting at the
        # model-input width the body consumed.
        w.var("I", "DINT")
        w.var("T", "REAL")
        w.comment("anomaly score: mean squared next-step forecast error")
        w.line("SCORE := 0.0;")
        w.line(f"FOR I := 0 TO {ctx.n_outputs - 1} DO")
        w.line(f"    T := {ctx.y}[I] - {ctx.x}[I + {ctx.in_width}];")
        w.line("    SCORE := SCORE + T * T;")
        w.line("END_FOR;")
        w.line(f"SCORE := SCORE / {w.real(float(ctx.n_outputs))};")
