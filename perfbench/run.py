"""Run one cell of the benchmark once and print its result line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

From the root of a checkout.  Set-up draws the weights on the card from
``--seed``, builds the engine and runs every shape the cell's traffic uses;
then the window runs whole engine calls back to back for ``--seconds``.
``--trace 1`` reports the per-layer metrics instead of the end-to-end
ones, from the same window and one more engine call under the profiler.
After the window the program's state is freed and a sample of the served
tokens is held against the plain reference (``perfbench/reference/``).
The last line of standard output is the result, as JSON; the numbers
compared, each with its limit, close standard error and the result.
Exits 2, printing no result, without enough CUDA cards, and 3 when a
forbidden module (JAX, or the JAX package ``repro``) was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from perfbench.lib import harness
    from perfbench.lib.manifest import Manifest

    chips = int(Manifest(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    harness.log("imports and the CUDA context", T0)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"compared tokens: {result['compared_tokens']}, widest gap "
          f"{result['widest_gap']!r} (not compared)", file=sys.stderr)
    for key, c in result["check"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
