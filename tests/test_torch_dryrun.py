"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) against
the reference's sharding rules, on the CPU.

Each case runs ``dryrun.run_case`` in a subprocess of its own (the fake
256-rank process group is process-global), at full width and one or two
layers (Jamba: one super-block of eight), on the fake ``(16, 16)`` mesh:
qwen3-8b ``train_4k``; mixtral-8x22b ``train_4k``, whose 8 experts on 16
model ranks take the FFN hidden-dim fallback; mamba2-370m ``decode_32k``;
Jamba ``prefill_32k``.  The subprocesses run concurrently, while this
process derives what each rank must hold from the reference's own rules
(``param_spec`` and ``sanitize`` per param leaf; ``cache_shardings`` per
cache leaf, its ``NamedSharding`` stood in for by the spec) on a stand-in
mesh whose ``.shape`` is ``{"data": 16, "model": 16}``, and the whole trees'
bytes from ``api.param_specs()``, ``jax.eval_shape(opt_init, ...)`` and
``api.cache_specs()``.  ``repro.launch.dryrun`` is never imported here: it
sets ``XLA_FLAGS`` to 512 host devices when imported.
"""

import json
import math
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs.base import INPUT_SHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import shardings as jsh
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.models.api import get_model as jget_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("qwen3_8b", "train_4k", 1), ("mixtral_8x22b", "train_4k", 1),
         ("mamba2_370m", "decode_32k", 2),
         ("jamba_1_5_large_398b", "prefill_32k", 8))
CASE_IDS = tuple(f"{a}-{s}" for a, s, _ in CASES)
MESH = types.SimpleNamespace(shape={"data": 16, "model": 16},
                             axis_names=("data", "model"))


def _run(arch, shape, n_layers):
    """``run_case``'s blob, from a fresh interpreter (not saved)."""
    code = ("import json, warnings; warnings.filterwarnings('ignore'); "
            "from repro_torch.launch.dryrun import run_case; "
            f"r = run_case({arch!r}, {shape!r}, n_layers={n_layers}, "
            "save=False); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        return {"error": proc.stderr[-4000:]}
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def blobs():
    with ThreadPoolExecutor(len(CASES)) as pool:
        futures = {f"{a}-{s}": pool.submit(_run, a, s, n)
                   for a, s, n in CASES}
        return {k: f.result() for k, f in futures.items()}


def _blob(blobs, case):
    blob = blobs[case]
    if "error" in blob:
        pytest.fail(blob["error"])
    return blob


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jsh._path_str(p), leaf) for p, leaf in flat]


def _local_numel(shape, spec):
    """Elements of one rank's shard of ``shape`` laid out by ``spec``."""
    n = 1
    for d, size in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        ways = math.prod(MESH.shape[a] for a in axes)
        assert size % ways == 0
        n *= size // ways
    return n


def _reference(arch, shape, n_layers, monkeypatch):
    """What the reference's rules give: per-rank bytes of each param and
    cache leaf, the per-rank optimizer bytes, and the whole trees'."""
    cfg = jget_config(arch).with_(n_layers=n_layers)
    api = jget_model(cfg)
    p_specs = api.param_specs()
    per_param = {path: _local_numel(
        leaf.shape, jsh.sanitize(jsh.param_spec(path, tuple(leaf.shape), cfg,
                                                MESH), tuple(leaf.shape),
                                 MESH)) * leaf.dtype.itemsize
        for path, leaf in _paths(p_specs)}
    out = {"params": per_param,
           "param_bytes": sum(int(np.prod(l.shape)) * l.dtype.itemsize
                              for _, l in _paths(p_specs))}
    shp = INPUT_SHAPES[shape]
    if shp["kind"] == "train":
        opt = jax.eval_shape(jmake_optimizer()[0], p_specs)
        out["opt_bytes"] = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                               for _, l in _paths(opt))
        # Moments like their params in f32 (0-d for integer leaves), and
        # the step.
        out["opt"] = 4 + sum(
            2 * 4 * (b // leaf.dtype.itemsize
                     if jnp.issubdtype(leaf.dtype, jnp.floating) else 1)
            for (_, leaf), b in zip(_paths(p_specs), per_param.values()))
    else:
        c_specs = api.cache_specs(shp["global_batch"], shp["seq_len"])
        # The rules' NamedSharding needs a real mesh: take the spec itself.
        monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
        c_shard = dict(_paths(jsh.cache_shardings(
            c_specs, cfg, MESH, batch_size=shp["global_batch"])))
        out["cache"] = {path: _local_numel(leaf.shape, c_shard[path])
                        * leaf.dtype.itemsize
                        for path, leaf in _paths(c_specs)}
        out["cache_bytes"] = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                                 for _, l in _paths(c_specs))
    return out


@pytest.mark.parametrize("case", CASE_IDS)
def test_per_rank_bytes_match_the_reference_rules(blobs, case, monkeypatch):
    arch, shape, n_layers = CASES[CASE_IDS.index(case)]
    got = _blob(blobs, case)
    want = _reference(arch, shape, n_layers, monkeypatch)
    assert got["per_rank_leaves"]["params"] == want["params"]
    assert got["per_rank"]["params"] == sum(want["params"].values())
    assert got["param_bytes"] == want["param_bytes"]
    if "opt" in want:
        assert got["opt_bytes"] == want["opt_bytes"]
        assert got["per_rank"]["opt"] == want["opt"]
    else:
        assert got["per_rank_leaves"]["cache"] == want["cache"]
        assert got["per_rank"]["cache"] == sum(want["cache"].values())
        assert got["cache_bytes"] == want["cache_bytes"]


@pytest.mark.parametrize("case", CASE_IDS)
def test_blob_has_the_reference_keys(blobs, case):
    """The reference's keys, those without a counterpart null; a rank
    computes and communicates."""
    blob = _blob(blobs, case)
    kind = INPUT_SHAPES[blob["shape"]]["kind"]
    keys = {"arch", "shape", "kind", "global_batch", "seq_len",
            "param_bytes", "quant", "variant", "unrolled", "mesh", "n_chips",
            "hlo_flops", "hlo_bytes", "cost_analysis", "memory_analysis",
            "collectives", "lower_s", "compile_s"}
    keys |= {"opt_bytes"} if kind == "train" else {"cache_bytes"}
    assert keys <= set(blob)
    assert blob["mesh"] == "16x16" and blob["n_chips"] == 256
    assert blob["hlo_bytes"] is None and blob["cost_analysis"] is None
    assert blob["memory_analysis"]["temp_bytes"] is None
    assert blob["collectives"]["bytes_by_type"] is None
    assert blob["hlo_flops"] > 0
    counts = blob["collectives"]["counts"]
    assert counts and all(n > 0 for n in counts.values())
    assert set(counts) <= {"all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "broadcast"}
