"""Each reference family against the port's own CPU path at the port's
``reduced()`` sizes, on the same drawn weights: plain float32 logits
equal to rounding; under SINT every quantized linear layer bit-exact on
the same input, and the Mamba-2 model's logits equal to rounding (in the
hybrid a last-bit difference upstream moves an activation code a whole
step somewhere in its eight layers, so its SINT logits are held by the
benchmark's own comparison, not here)."""

from __future__ import annotations

import importlib

import pytest
import torch

from perfbench.lib import program
from perfbench.lib.weights import leaves
from perfbench.reference import common as rc
from perfbench.tests import tiny

FAMILIES = ("ssm", "hybrid")


def _setup(family, quant, seed=3):
    cfg = program.program_config({"program": tiny.program(family, quant)})
    cfg = cfg.with_(dtype=torch.float32)
    model = dict(tiny.MODELS[family]["model"], quant=quant)
    drawn = program.weights(cfg, seed, torch.device("cpu"))
    # f32 leaves: the reference reads what the f32 program holds.
    drawn.specs = {p: torch.empty(s.shape, dtype=torch.float32,
                                  device="meta")
                   for p, s in drawn.specs.items()}
    return cfg, model, drawn


def _logits(family, quant, tokens):
    cfg, model, drawn = _setup(family, quant)
    params = program.params(cfg, drawn)
    mod = importlib.import_module(
        f"repro_torch.models.{'mamba2' if family == 'ssm' else family}")
    with torch.no_grad():
        got = mod.forward_logits(params, cfg, tokens)
        ref = importlib.import_module(f"perfbench.reference.{family}")
        prec = rc.Precision(quant)
        x = ref.hidden(drawn.get, model, prec, tokens)
        b, t = tokens.shape
        rows = torch.arange(b).repeat_interleave(t)
        cols = torch.arange(t).repeat(b)
        want = rc.logits_at(drawn.get, prec, x, rows, cols).reshape(b, t, -1)
    return got, want


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_matches_port_in_f32(family):
    tokens = torch.randint(0, 1024, (2, 48), generator=torch.Generator()
                           .manual_seed(0))
    got, want = _logits(family, None, tokens)
    scale = want.abs().max()
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * scale), \
        (got - want).abs().max() / scale


@pytest.mark.parametrize("family", FAMILIES)
def test_every_sint_linear_is_bit_exact(family):
    """The reference's SINT product equals the port's linear layer on the
    same f32 input, for every quantized weight of the model (codes and
    scales worked out apart on each side)."""
    from repro_torch.models import common as cm
    cfg, _, drawn = _setup(family, "SINT")
    params = program.params(cfg, drawn)
    prec = rc.Precision("SINT")
    x_gen = torch.Generator().manual_seed(5)
    paths = [p[:-1] + ("w",) for p, _ in leaves(program.template(cfg))
             if p[-1] == "qw"]
    assert paths
    for path in paths:
        node = params
        for k in path[:-1]:
            node = node[k]
        w = drawn.get(path)
        lead = tuple(w.shape[:-2])
        for idx in [tuple(0 for _ in lead), tuple(s - 1 for s in lead)]:
            layer = {k: v[idx] for k, v in node.items()}
            x = torch.randn((5, w.shape[-2]), generator=x_gen) * 0.7
            got = cm.linear(layer, x, backend="ref")
            assert torch.equal(got, prec.dense(x, w[idx])), path


def test_ssm_reference_matches_port_under_sint():
    tokens = torch.randint(0, 1024, (2, 48), generator=torch.Generator()
                           .manual_seed(1))
    got, want = _logits("ssm", "SINT", tokens)
    scale = want.abs().max()
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * scale)
