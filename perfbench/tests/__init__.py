"""CPU tests of the benchmark: ``python -m pytest -q perfbench/tests`` from
the root of the repository (the port's package is put on the path here,
as ``perfbench/run.py`` puts it)."""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
