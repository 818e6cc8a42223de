"""The control at the tiny sizes: the reference one precision lower (int4
weight codes, fp8 bf16 weights) puts first tokens that fail one of each
cell's tiny limits, on every seed, where the program's own pass them
(``perfbench/control.py`` reads the same at the cells' sizes on the
card)."""

from __future__ import annotations

import pytest
import torch

from perfbench.lib.manifest import Manifest
from perfbench.tests import test_bench_faults as tf
from perfbench.tests import tiny


@pytest.mark.parametrize("cell", tf.CELLS)
def test_control_fails_the_limit_the_program_passes(tmp_path, cell):
    from perfbench import control
    bench = Manifest(tiny.make_root(tmp_path, tf.TINY_LIMITS, sample=8))
    for seed in (3, 2**31 + 5):
        r = control.readings(bench, cell, seed, 2, torch.device("cpu"))
        limits = tf.TINY_LIMITS[cell]
        assert all(r[f"program_{k}"] <= v for k, v in limits.items()), r
        assert any(r[f"control_{k}"] > v for k, v in limits.items()), r
