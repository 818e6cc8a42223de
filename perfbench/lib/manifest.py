"""``BENCHMARK.json``: the cells, configurations and metrics, found by name,
and the rules their names and units keep."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data: Dict[str, Any] = json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, kind: str, cell: str) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports: those without a ``workloads`` list, and those whose list
        names it."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def load_json(self, rel: str) -> Dict[str, Any]:
        return json.loads((self.root / rel).read_text())
