"""Readings that set a cell's limits: the program's numbers
(``lib/check.py``: the mean gap, the worst request's mean gap) and the
control's, with the widest gap and each request's mean gap, seed by seed,
at the cell's own size and load.

  python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \\
      [--calls N]

On the card, from the root of a checkout.  For each seed: set-up as a run
makes it, ``--calls`` engine calls of the cell's traffic (enough to
finish its longest requests and to give the sample a run compares), the
program's state freed, then the same sample of served tokens read by the
reference (the program's gaps) and by the control (the reference a
precision lower, ``reference/common.py``: the gap of the token it puts
first).  One JSON line per seed on standard output.  The benchmark's own
runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(bench, name, seed, calls, device):
    from perfbench.lib import check, harness
    t0 = time.perf_counter()
    sess = harness.open_session(bench, name, seed, device, t0)
    done = [sess.driver.call() for _ in range(calls)]
    items = check.sample(harness.served(done),
                         int(sess.workload["check"]["sample"]), seed)
    harness.free_program(sess, device)
    gaps, control = harness.compare(sess, items, device, control=True)
    out = {"workload": name, "seed": seed,
           "tokens": sum(len(r) for r in gaps),
           "call_s": [c.end_s - c.start_s for c in done],
           "seconds": time.perf_counter() - t0}
    for side, per_request in (("program", gaps), ("control", control)):
        flat = [g for r in per_request for g in r]
        for key, value in check.numbers(per_request).items():
            out[f"{side}_{key}"] = value
        out[f"{side}_widest"] = max(flat)
        out[f"{side}_zero"] = sum(g == 0 for g in flat) / len(flat)
        out[f"{side}_request_means"] = [sum(r) / len(r) for r in per_request]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args()

    import torch

    from perfbench.lib.manifest import Manifest
    if not torch.cuda.is_available():
        print("perfbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = Manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(bench, args.workload, seed, args.calls,
                                  torch.device("cuda", 0))), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
