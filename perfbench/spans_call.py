"""The program's own spans and counters in one engine call of a cell, on the
card, read with the same call's device trace (``lib/program_trace.py``).

  python3 perfbench/spans_call.py --workload <cell> --seed <n> [--pairs 1]

From the root of a checkout.  Set-up as a run makes it; then

1. ``--pairs`` pairs of one backlog of requests served with the tracer
   off and on (in turns, off first), before any profiler session (one
   leaves the process's launches slower): their wall times and whether
   every served token is the same;
2. one call with the tracer off and the device traced, read as the
   benchmark's traced call reads ``device_idle`` and ``step_ms``;
3. the spans call: one engine call of the cell's traffic with the
   program's tracer (``repro_torch.trace``) on and the device traced alone
   (``profiling.trace``), retaken when the trace lost a ``qmatmul`` or
   ``ssd_scan`` record (counted by the kernels' ``launches``); its
   readings, the call's own idle share and ``step_ms`` as
   ``lib/spans.py`` reads it from the call's ``ServeStats``;
4. step 2 again (a process's profiled calls drift: the spans call is read
   against the calls on both sides of it).

The tracer records device time for the spans the readings read
(``program_trace.DEVICE_SPANS``).  ``spans_call(driver)`` is the spans
call alone, on a harness driver's public face (``kind``, ``call()``):
the one function a traced run would call after its traced calls, its
result read by ``program_trace.readings``.

One JSON line on standard output.  The benchmark's own runs never run
this: the tracer stays off in them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _step_ms(call):
    """``step_ms`` of one continuous call, as ``lib/spans.step_s`` reads the
    window's: ``ServeStats.wall_s`` less the admissions' ``prefill_s``,
    over the steps."""
    st = call.stats
    return 1e3 * (st.wall_s - sum(d.prefill_s for d in call.done)) / st.steps


def spans_call(driver):
    """The spans call: one engine call with the program's tracer on and the
    device traced alone, retaken when the trace lost a ``qmatmul`` or
    ``ssd_scan`` record.  Returns (the tracer's drained dict, the device
    trace, the call)."""
    from perfbench.lib import profiling, program_trace
    from repro_torch import trace
    from repro_torch.kernels import qmatmul, ssd_scan
    got = {}

    def one():
        trace.drain()                 # a retaken call's spans go
        before = qmatmul.launches, ssd_scan.launches
        got["call"] = driver.call()
        got["expect"] = {"qmatmul_kernel": qmatmul.launches - before[0],
                         "ssd_scan_kernel": ssd_scan.launches - before[1]}

    trace.enable(program_trace.DEVICE_SPANS[driver.kind])
    try:
        tr = profiling.trace(one, lambda: got["expect"])
        doc = trace.drain()
    finally:
        trace.disable()
    return doc, tr, got["call"]


def _idle(tr):
    from perfbench.lib import profiling
    busy, window = profiling.busy_and_window(tr)
    return 100.0 * (1.0 - busy / window)


def on_off_pairs(driver, pairs):
    """Serve one call's requests ``pairs`` times with the tracer off and on
    (the driver's generator rewound before each call): (wall seconds off,
    wall seconds on, every token the same)."""
    from perfbench.lib import program_trace
    from repro_torch import trace
    gen = copy.deepcopy(driver.gen)
    walls = {False: [], True: []}
    served = []
    for _ in range(pairs):
        for on in (False, True):
            driver.gen = copy.deepcopy(gen)
            if on:
                trace.enable(program_trace.DEVICE_SPANS[driver.kind])
            call = driver.call()
            walls[on].append(call.end_s - call.start_s)
            trace.disable()
            trace.drain()
            served.append({d.uid: [int(t) for t in d.tokens]
                           for d in call.done})
    return walls[False], walls[True], all(s == served[0] for s in served)


def measure(name, seed, pairs, device):
    import torch

    from perfbench.lib import harness, program_trace
    from perfbench.lib.manifest import Manifest
    sess = harness.open_session(Manifest(ROOT), name, seed, device, T0)
    out = {"workload": name, "seed": seed,
           "device": torch.cuda.get_device_name(device),
           "setup_s": time.perf_counter() - T0}

    off, on, same = on_off_pairs(sess.driver, pairs)
    out.update(serve_off_s=off, serve_on_s=on, tokens_same=same,
               on_cost=sum(on) / sum(off) - 1.0)

    def traced_off():
        got = {}
        tr_off = harness.profiling.trace(
            lambda: got.setdefault("c", sess.driver.call()))
        out.setdefault("device_idle_tracer_off", []).append(_idle(tr_off))
        if got["c"].stats is not None:
            out.setdefault("step_ms_tracer_off", []).append(
                _step_ms(got["c"]))

    traced_off()
    at = time.perf_counter()
    doc, tr, call = spans_call(sess.driver)
    out["spans_call_s"] = time.perf_counter() - at
    device_us = [(s, e) for _, s, e in tr.device]
    out["readings"] = program_trace.readings(doc, device_us)
    eng, model, length = program_trace.idle_split(doc, device_us)
    out["serve_s"] = length / 1e6
    out["idle_share"] = 100.0 * (eng + model) / length
    out["idle_share_of_traced_call"] = _idle(tr)
    out["spans"] = len(doc["spans"])
    out["counters"] = doc["counters"]
    out["call_s"] = call.end_s - call.start_s
    if call.stats is not None:
        st = call.stats
        r = out["readings"]
        steps = program_trace.named(doc, "engine.step")
        out.update(steps=st.steps, admitted=st.admitted,
                   step_ms=_step_ms(call),
                   step_host_ms=sum(s["end_ns"] - s["start_ns"]
                                    for s in steps) / len(steps) / 1e6)
        out["step_terms_ms"] = {
            "step_device_ms": r.get("step_device_ms"),
            "admit_ms_x_admitted_over_steps":
                r.get("admit_ms", 0.0) * st.admitted / st.steps,
            "engine_idle_over_steps":
                1e3 * r.get("idle_in_engine", 0.0) / 100.0
                * out["serve_s"] / st.steps}
        out["step_terms_sum_ms"] = sum(
            v or 0.0 for v in out["step_terms_ms"].values())
    traced_off()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("perfbench: the spans call runs on a CUDA card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    out = measure(args.workload, args.seed, args.pairs, device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
