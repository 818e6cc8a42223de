"""``BENCHMARK.json`` against the contract's rules, and every file it
implies found where the harness looks for it by name."""

from __future__ import annotations

import importlib
import json

import pytest

from perfbench.lib import check, manifest, traffic
from perfbench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _reports(cell, kind):
    return [m["name"] for m in BENCH[kind]
            if "workloads" not in m or cell in m["workloads"]]


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s of compile a cell, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit_keeps_to_the_allowed_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                         "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert manifest.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_metric_keys_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]


def test_every_moves_is_reported_in_each_of_the_metrics_cells():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E, m
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            assert m["moves"] in _reports(cell, "end_to_end"), (m, cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = _reports(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reports(w["name"], "per_layer")
        assert w["chips"] in (1, 4)


def test_every_file_the_harness_finds_by_name_is_there():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in data["model"] and key in data.get("published", {})
        importlib.import_module(f"perfbench.reference.{data['family']}")
        importlib.import_module(f"perfbench.work.{data['family']}")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for w in BENCH["workloads"]:
        data = json.loads((REPO / "perfbench" / "workloads"
                           / f"{w['name']}.json").read_text())
        t = data["traffic"]
        importlib.import_module(f"perfbench.drivers.{t['driver']}")
        for spec in (t["prompt_len"], t["new_tokens"]):
            assert t["backlog"] % len(traffic.levels(spec)) == 0
        assert max(traffic.levels(t["prompt_len"])) \
            + max(traffic.levels(t["new_tokens"])) <= t["cache_len"]
        limits = data["check"]["limits"]
        assert set(limits) == set(check.NUMBERS)
        assert all(v > 0 for v in limits.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_names_are_those_of_perf_md(m):
    perf = (REPO / "PERF.md").read_text()
    assert f"`{m['layer']}`" in perf
