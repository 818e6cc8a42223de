"""The port's user entry points (``repro_torch.examples``) against the
reference's scripts under ``examples/`` and the JAX package, on the CPU.

* ``detect_fleet --list`` (a real ``python -m`` subprocess) prints the
  reference's scenario table byte for byte.
* The per-plant table: the reference's init params, SINT-quantized by the
  reference and bridged in, served by the port's ``StreamEngine`` on the CPU
  and by the reference's over four named scenarios x 240 cycles: the same
  verdict labels and the same rows (onset, first flag, latency, FPs).  The
  table function on a hand-computed case.  The unsharded table equal to
  two spawned gloo ranks' (``--devices 2``) and to ``--async``'s on the
  same params.  ``--mixed --smoke`` prints the per-group verdicts and the
  serve stats.
* The case study: a detector trained by the port, bridged to the
  reference, deployed in both packages' scan loops (REAL and SINT): the same
  ``(done_cycle, pred)`` sequence over a shortened attack run, and the same
  Wd traces with and without the defense.
* ``export_st --smoke``: the contract lines and the ``.st`` file that
  ``tests/test_examples_cli.py`` checks of the reference.
* ``quickstart``: its checks pass, and its plan bytes and Table 2 memory
  line equal the reference's.
* ``serve_llm`` and ``train_llm`` run on the CPU; the training checkpoint
  restores in the reference.
* Every module raises without CUDA unless given ``--device cpu``.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.configs import get_config as jget_config
from repro.core import SlidingWindowDetector as JSlidingWindowDetector
from repro.core import layers as JL
from repro.core import quantize as jquantize
from repro.core import sequential as jsequential
from repro.models import get_model as jget_model
from repro.serving import StreamEngine as JStreamEngine
from repro.sim import build_detector as jbuild_detector
from repro.sim import build_fleet as jbuild_fleet
from repro.sim import simulate as jsimulate
from repro.sim.scenarios import scenario_table as jscenario_table
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint import restore
from repro_torch.configs import msf_detector as spec
from repro_torch.examples import (casestudy_msf, detect_fleet, export_st,
                                  quickstart, serve_llm, train_llm)
from repro_torch.sim import build_dataset, train_detector

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_SCENARIOS = "baseline,drift-then-spoof,stealth-drift,tb0-spoof"


def labels(verdicts):
    return [(v.stream, v.cycle, v.pred) for v in verdicts]


def to_jax(params):
    return {uid: {k: jnp.asarray(v) for k, v in p.items()}
            for uid, p in params_to_numpy(params).items()}


# -- detect_fleet -----------------------------------------------------------


def test_detect_fleet_list_is_the_reference_table():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.detect_fleet", "--list"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout == jscenario_table() + "\n"


@pytest.fixture(scope="module")
def table_args():
    return detect_fleet.parse_args(["--scenarios", TABLE_SCENARIOS,
                                    "--plants", "4", "--cycles", "240",
                                    "--device", "cpu"])


@pytest.fixture(scope="module")
def table_detectors(case_detector):
    """SINT classifiers for the table, as (port detectors, reference params):
    the reference's init params, quantized by the reference on held-out
    benign windows and bridged in (as ``examples/export_st.py --smoke``
    makes them), and the case study's trained classifier."""
    from repro_torch.sim import build_detector
    model = jbuild_detector()
    params = model.init_params(jax.random.PRNGKey(0))
    calib = export_st.calibration_windows(4, 240, 7, spec.STRIDE)
    params = jquantize.quantize_params(
        model, params, "SINT",
        calibration=jquantize.calibration_samples(calib, k=16))
    ported, trained, jtrained = case_detector["SINT"]
    return {"init": ((build_detector(), params_from_numpy(params,
                                                          device="cpu"),
                      None), params),
            "trained": ((ported, trained, None), jtrained)}


@pytest.fixture(scope="module")
def port_runs(table_args, table_detectors):
    return {kind: detect_fleet.serve_fleet(table_args, det)
            for kind, (det, _) in table_detectors.items()}


@pytest.mark.parametrize("kind", ["init", "trained"])
def test_table_matches_reference_engine(table_args, table_detectors,
                                        port_runs, kind):
    engine = JStreamEngine(jbuild_detector(), table_detectors[kind][1],
                           n_streams=4, shard=False)
    engine.warmup()
    fleet = jbuild_fleet(TABLE_SCENARIOS.split(","), 4, seed=1000)
    want = engine.run(fleet, 240) + engine.flush()
    got = port_runs[kind].verdicts
    assert labels(got) == labels(want)
    if kind == "trained":             # the labels carry information
        assert 0 < sum(v.pred != 0 for v in want) < len(want)
    got_rows = detect_fleet.plant_table(detect_fleet.make_fleet(table_args),
                                        got)
    want_rows = detect_fleet.plant_table(fleet, want)
    assert got_rows == want_rows
    assert [r.plant for r in got_rows] == [p.name for p in fleet]


def test_table_by_hand():
    fleet = [types.SimpleNamespace(name=n) for n in
             ("baseline#0", "drift-then-spoof#1", "tb0-spoof#2",
              "steam-pulse#3")]
    v = types.SimpleNamespace
    verdicts = [v(stream=0, cycle=199, pred=1), v(stream=1, cycle=199, pred=1),
                v(stream=2, cycle=199, pred=0), v(stream=0, cycle=209, pred=0),
                v(stream=1, cycle=209, pred=0), v(stream=1, cycle=219, pred=1),
                v(stream=1, cycle=229, pred=1), v(stream=3, cycle=409, pred=2),
                v(stream=0, cycle=419, pred=1)]
    rows = detect_fleet.plant_table(fleet, verdicts,
                                    [("a", 0, 2), ("b", 2, 2)])
    R = detect_fleet.PlantRow
    lat = (219 - 200) * 0.1
    assert rows == [R("baseline#0", "a", None, None, None, 2),
                    R("drift-then-spoof#1", "a", 200, 219, lat, 1),
                    R("tb0-spoof#2", "b", 400, None, None, 0),
                    R("steam-pulse#3", "b", 400, 409, (409 - 400) * 0.1, 0)]
    lines = detect_fleet.format_table(rows, mixed=True)
    assert lines[0] == ("plant                      group      onset "
                        "first-flag   latency pre-onset FPs")
    assert lines[2] == ("drift-then-spoof#1         a            200"
                        "        219      1.9s             1")
    assert lines[3].split() == ["tb0-spoof#2", "b", "400", "miss", "miss",
                                "0"]
    assert detect_fleet.format_table(rows[:1], mixed=False)[1].split() == \
        ["baseline#0", "-", "-", "-", "2"]


def test_sharded_and_async_tables_equal_unsharded(table_args,
                                                  table_detectors, port_runs):
    detectors, unsharded = table_detectors["trained"][0], port_runs["trained"]
    fleet = detect_fleet.make_fleet(table_args)
    want = detect_fleet.plant_table(fleet, unsharded.verdicts)
    two = detect_fleet.parse_args(["--scenarios", TABLE_SCENARIOS,
                                   "--plants", "4", "--cycles", "240",
                                   "--devices", "2", "--device", "cpu"])
    sharded = detect_fleet.serve(two, detectors)
    assert labels(sharded.verdicts) == labels(unsharded.verdicts)
    assert detect_fleet.plant_table(fleet, sharded.verdicts) == want
    assert sharded.stats.collectives["data"] == sharded.stats.steps
    lagged = detect_fleet.parse_args(["--scenarios", TABLE_SCENARIOS,
                                      "--plants", "4", "--cycles", "240",
                                      "--async", "--device", "cpu"])
    run = detect_fleet.serve(lagged, detectors)
    assert labels(run.verdicts) == labels(unsharded.verdicts)
    assert detect_fleet.plant_table(fleet, run.verdicts) == want
    assert set(run.sustained) == {0, 1} and min(run.sustained.values()) > 0


def test_mixed_smoke_prints_group_verdicts_and_stats(capsys):
    detect_fleet.main(["--mixed", "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "per-group verdicts: mlp=5  ae=5  margin=5  forecast=5" in out
    assert "serve stats: 5 detector steps, 20 windows" in out
    assert "(mixed: 1xmlp + 1xae + 1xmargin + 1xforecast / SINT)" in out


# -- the case study ---------------------------------------------------------


@pytest.fixture(scope="module")
def case_detector():
    """A classifier trained by the port on a small dataset, ported, and its
    SINT twin: {scheme: (port model, port params, reference params)}."""
    x, y = build_dataset(normal_cycles=6_000, attack_cycles=1_000, stride=8,
                         seed=0)
    model, res = train_detector(x, y, epochs=6, patience=6, lr=1e-3,
                                device="cpu")
    ported, params = casestudy_msf.port(model, res.params, x)
    qparams, _ = casestudy_msf.quantize_ported(ported, params, x, y, "SINT")
    return {s: (ported, p, to_jax(p))
            for s, p in (("REAL", params), ("SINT", qparams))}


def reference_attack_run(params, n_cycles, attack_start):
    det = JSlidingWindowDetector(jbuild_detector(), params, window=200,
                                 n_features=2, n_segments=4)
    results = []

    def hook(cycle, reading):
        det.push(np.array([(reading[0] - 89.6) / 2.0,
                           (reading[1] - 19.18) / 0.5], np.float32))
        r = det.tick(cycle)
        if r is not None:
            results.append(r)

    jsimulate(n_cycles, attack_id=2, attack_start=attack_start, seed=777,
              defense_hook=hook)
    return results


@pytest.mark.parametrize("scheme", ["REAL", "SINT"])
def test_casestudy_attack_run_matches_reference(case_detector, scheme):
    model, params, jparams = case_detector[scheme]
    got = casestudy_msf.attack_run(model, params, 4, n_cycles=600,
                                   attack_start=300)
    want = reference_attack_run(jparams, 600, 300)
    assert [(d, p) for d, p, _ in got] == [(d, p) for d, p, _ in want]
    assert all(lat == 4 for _, _, lat in got)
    preds = [p for _, p, _ in got]
    assert 0 in preds and any(p != 0 for p in preds)
    first = casestudy_msf.first_detection(got)
    assert first == next(d for d, p, _ in want if p != 0)


def test_casestudy_wd_traces_match_reference(case_detector):
    model, params, jparams = case_detector["SINT"]
    off, on = casestudy_msf.wd_run(model, params, 4, n_cycles=600)
    det = JSlidingWindowDetector(jbuild_detector(), jparams, window=200,
                                 n_features=2, n_segments=4)

    def hook(cycle, reading):
        det.push(np.array([(reading[0] - 89.6) / 2.0,
                           (reading[1] - 19.18) / 0.5], np.float32))
        det.tick(cycle)

    want_off = jsimulate(600, seed=123).wd_meas
    want_on = jsimulate(600, seed=123, defense_hook=hook).wd_meas
    np.testing.assert_array_equal(off, want_off)
    np.testing.assert_array_equal(on, want_on)
    np.testing.assert_array_equal(on, off)


# -- export_st --------------------------------------------------------------


@pytest.mark.parametrize("detector,quant", [("mlp", "SINT"),
                                            ("ae", "REAL")])
def test_export_st_smoke(tmp_path, capsys, detector, quant):
    export_st.main(["--smoke", "--detector", detector, "--quant", quant,
                    "--out-dir", str(tmp_path), "--device", "cpu"])
    assert "OK: exported ST serves identically" in capsys.readouterr().out
    text = (tmp_path / f"{detector}_{quant.lower()}.st").read_text()
    assert text.startswith("FUNCTION_BLOCK")
    assert text.rstrip().endswith("END_FUNCTION_BLOCK")


def test_export_st_smoke_reports_contract(tmp_path, capsys):
    export_st.main(["--smoke", "--detector", "ae", "--quant", "SINT",
                    "--out-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bit-exact (SINT) contract" in out
    assert "verdict parity   : 108/108" in out


# -- quickstart, serve_llm, train_llm --------------------------------------


def test_quickstart_checks_and_plan_match_reference(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "planned (arena) inference == reference inference ✓" in out
    assert "multipart output identical to single-shot ✓" in out
    model = jsequential(
        [JL.Input(), JL.Dense(units=128, activation="relu"),
         JL.Dense(units=64, activation="relu"),
         JL.Dense(units=10, activation="softmax")], input_shape=(32,))
    assert (f"activation arena: {model.memory_plan().arena_bytes} B (naive "
            f"layout would be {model.memory_plan(reuse=False).arena_bytes} B)"
            ) in out
    table2 = {s: jquantize.memory_report(512, 512, s)["total"]
              for s in ("SINT", "INT", "DINT", "REAL")}
    assert f"512x512 layer memory (Table 2): {table2}" in out
    assert "pruned sparsity of layer 1: 0.50" in out


def test_serve_llm_mamba2_on_cpu(capsys):
    serve_llm.main(["--arch", "mamba2_370m", "--requests", "2",
                    "--max-new", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "serving mamba2-370m (reduced) quant=None kv_quant=False"
    assert [ln.split(":")[0] for ln in lines[1:]] == ["req 0", "req 1"]


def test_train_llm_checkpoint_restores_in_reference(tmp_path, capsys):
    train_llm.main(["--steps", "2", "--seq", "32", "--batch", "2",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "model: 12L d512 -> 52.2M params" in out
    assert "loss " in out.splitlines()[-2]
    cfg = jget_config("qwen3_8b").with_(n_layers=12, d_model=512, n_heads=8,
                                        n_kv_heads=4, d_ff=1408, vocab=32768)
    like = jax.eval_shape(jget_model(cfg).init, jax.random.PRNGKey(0))
    back = jrestore(str(tmp_path), {"params": like})["params"]
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                              device="meta"), like)
    mine = restore(str(tmp_path), {"params": meta}, device="cpu")["params"]
    want = jax.tree_util.tree_leaves(back)
    got = jax.tree_util.tree_leaves(mine)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))


# -- the device contract ----------------------------------------------------


@pytest.mark.parametrize("module,argv", [
    (detect_fleet, []), (detect_fleet, ["--mixed", "--device", "cuda"]),
    (casestudy_msf, ["--fast"]), (export_st, ["--smoke"]),
    (quickstart, []), (serve_llm, ["--arch", "mamba2_370m"]),
    (train_llm, ["--steps", "1", "--device", "cuda"])],
    ids=["detect_fleet", "detect_fleet_mixed", "casestudy_msf", "export_st",
         "quickstart", "serve_llm", "train_llm"])
def test_cuda_default_raises_without_cuda(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
