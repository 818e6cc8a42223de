"""The whole run of each cell, with the program on the CPU at the tiny sizes
(``tiny.py``), comes out correct as it is and not correct with the timed
path broken underneath: a token altered where it is produced, a decode
step that leaves its state unchanged, half of the batch left out.  (The
cells run on one chip: there is no exchange between chips to leave out.)
The limit here is the tiny models' own, set between their sound readings
and their faults' as the cells' limits are set at full size."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from perfbench.lib import harness
from perfbench.tests import tiny

CELLS = ("mamba2-370m.docs-2k", "jamba-1.5-large.chat")
# Readings at the tiny sizes (mean gap; worst request's mean gap), sound
# over six seeds: docs 0-0.00060; 0-0.0024, chat 0.0091-0.049;
# 0.035-0.17.  The three faults: docs 0.36-0.83; 0.59-0.99, chat
# 0.69-1.03; 1.10-1.25.  The control (test_bench_control.py), two seeds:
# docs 0.094-0.108; 0.20-0.22, chat 0.54-0.59; 0.66-0.71.
TINY_LIMITS = {
    "mamba2-370m.docs-2k": {"mean_gap": 0.03, "worst_request_gap": 0.05},
    "jamba-1.5-large.chat": {"mean_gap": 0.15, "worst_request_gap": 0.4},
}
SEEDS = (2**31 + 11, 7)


def run(tmp_path, cell, seed):
    root = tiny.make_root(tmp_path, TINY_LIMITS, sample=8)
    return harness.run_cell(root, cell, seed, 0.05, False,
                            torch.device("cpu"), time.perf_counter())


def _model_module(cell):
    from repro_torch.models import hybrid, mamba2
    return mamba2 if cell.startswith("mamba2") else hybrid


def altered_token(monkeypatch, cell):
    from repro_torch.serving import continuous, engine
    orig = engine.sample_batched

    def bad(logits, temps, gen):
        return (orig(logits, temps, gen) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_batched", bad)
    monkeypatch.setattr(continuous, "sample_batched", bad)


def state_unchanged(monkeypatch, cell):
    mod = _model_module(cell)
    name = "decode_step" if cell.startswith("mamba2") else \
        "decode_step_multi"
    orig = getattr(mod, name)

    def bad(params, cfg, cache, tokens, pos, **kw):
        _, logits = orig(params, cfg, copy.deepcopy(cache), tokens, pos, **kw)
        return cache, logits
    monkeypatch.setattr(mod, name, bad)


def half_batch(monkeypatch, cell):
    """The wave's prefill runs its first half of rows only (the rest take
    copies of them); the continuous step decodes its first half of slots
    only (the rest take their logits)."""
    mod = _model_module(cell)

    def tile(t, b):
        return torch.cat([t, t], dim=0)[:b] if t.shape[0] * 2 >= b else t

    if cell.startswith("mamba2"):
        orig = mod.prefill

        def bad(params, cfg, tokens, cache_len, **kw):
            b = tokens.shape[0]
            states, logits = orig(params, cfg, tokens[:b // 2], cache_len,
                                  **kw)
            return ({k: torch.cat([v, v], dim=1)[:, :b]
                     for k, v in states.items()}, tile(logits, b))
        monkeypatch.setattr(mod, "prefill", bad)
    else:
        orig = mod.decode_step_multi

        def bad(params, cfg, cache, tokens, pos, **kw):
            cache, logits = orig(params, cfg, cache, tokens, pos, **kw)
            b = logits.shape[0]
            return cache, tile(logits[:b // 2], b)
        monkeypatch.setattr(mod, "decode_step_multi", bad)


FAULTS = {"altered_token": altered_token, "state_unchanged": state_unchanged,
          "half_batch": half_batch}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell, seed):
    out = run(tmp_path, cell, seed)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    out = run(tmp_path, cell, SEEDS[0])
    assert not out["correct"], out["check"]
