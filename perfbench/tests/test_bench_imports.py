"""What the benchmark may import: no module under ``perfbench/`` names
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (top-level names
compared whole: the port's ``repro_torch`` is another name), and the
reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from perfbench.lib.harness import FORBIDDEN, forbidden_modules
from perfbench.tests.tiny import REPO

FILES = sorted((REPO / "perfbench").rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name in ("reference", "work")
             or p.name in ("bounds.py", "stats.py", "check.py")],
    ids=lambda p: str(p.relative_to(REPO)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert forbidden_modules() == ["repro"]
