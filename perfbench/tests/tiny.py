"""Cells at the port's ``reduced()`` sizes, written under a temporary root
beside a ``BENCHMARK.json`` of the same names, so that the CPU tests run
the whole harness with the program on the CPU."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parents[2]

MODELS = {
    "ssm": {
        "arch": "mamba2_370m",
        "model": {"n_layers": 2, "d_model": 256, "vocab": 1024,
                  "ssm_state": 32, "ssm_expand": 2, "ssm_headdim": 32,
                  "ssm_groups": 1, "conv_kernel": 4, "dtype": "bfloat16",
                  "quant": "SINT"},
    },
    "hybrid": {
        "arch": "jamba_1_5_large_398b",
        "model": {"n_layers": 8, "d_model": 256, "n_heads": 4,
                  "n_kv_heads": 2, "d_ff": 512, "vocab": 1024,
                  "n_experts": 4, "top_k": 2, "attn_period": 8,
                  "ssm_state": 32, "ssm_expand": 2, "ssm_headdim": 32,
                  "ssm_groups": 8, "conv_kernel": 4, "rope_theta": 10000.0,
                  "dtype": "bfloat16", "quant": "SINT"},
        "extra": {"capacity_factor": 2.0},
    },
}

TRAFFIC = {
    "mamba2-370m.docs-2k": {
        "driver": "wave", "slots": 4, "cache_len": 68, "backlog": 4,
        "prompt_len": {"fixed": 64}, "new_tokens": {"fixed": 4}},
    "jamba-1.5-large.chat": {
        "driver": "continuous", "slots": 4, "cache_len": 96, "backlog": 16,
        "prompt_len": {"log_uniform": [8, 40]},
        "new_tokens": {"log_uniform": [4, 16]}},
}


def program(family: str, quant="SINT"):
    m = MODELS[family]
    over = {k: v for k, v in m["model"].items()
            if k not in ("dtype", "rope_theta")}
    over["quant"] = quant
    over.update(m.get("extra", {}))
    return {"arch": m["arch"], "overrides": over}


def make_root(tmp: Path, limits: Dict[str, Dict[str, float]],
              sample: int = 4) -> Path:
    """A root holding the real ``BENCHMARK.json`` with each config's file
    at the tiny sizes, each cell's mix shrunk and its ``limits``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "perfbench" / "configs").mkdir(parents=True)
    (tmp / "perfbench" / "workloads").mkdir(parents=True)
    for c in bench["configs"]:
        real = json.loads((REPO / c["file"]).read_text())
        fam = real["family"]
        real["model"] = dict(MODELS[fam]["model"])
        real["program"] = program(fam)
        (tmp / c["file"]).write_text(json.dumps(real))
    for w in bench["workloads"]:
        (tmp / "perfbench" / "workloads" / f"{w['name']}.json").write_text(
            json.dumps({"traffic": TRAFFIC[w["name"]],
                        "check": {"sample": sample, "block": 4,
                                  "limits": limits[w["name"]]}}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
