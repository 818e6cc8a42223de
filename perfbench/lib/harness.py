"""One run of one cell: set-up, the measured window, the traced call, the
comparison with the reference, and the result line's fields.

Everything a cell needs is found by name: its mix
(``perfbench/workloads/<cell>.json``), its configuration (the file that
``BENCHMARK.json`` names), the driver its mix names
(``perfbench/drivers/<driver>.py``), the reference and the work counts of
its family (``perfbench/reference/<family>.py``,
``perfbench/work/<family>.py``) and each metric's reader
(``perfbench/metrics/<metric>.py``).  The data files are read under the
checkout's root; the code is this package's.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench.lib import check, profiling, program, rooflines, traffic
from perfbench.lib.call import Call
from perfbench.lib.manifest import Manifest
from perfbench.reference import common as rc

# Top-level module names that must not be loaded when the result prints.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: str
    workload: Dict[str, Any]
    model: Dict[str, Any]            # the configuration file's sizes
    work: Any                        # perfbench/work/<family>.py
    calls: List[Call]
    window_s: float
    setup_s: float
    trace: Optional[profiling.Trace] = None
    launches: Optional[program.Launches] = None


METRICS = Path(__file__).resolve().parent.parent / "metrics"


def _metric_reader(name: str):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log(what: str, since: float) -> float:
    """One phase's wall seconds on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"perfbench: {what} {now - since:.3f} s", file=sys.stderr,
          flush=True)
    return now


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(driver, seconds: float) -> List[Call]:
    """Whole engine calls back to back until ``seconds`` have passed."""
    calls: List[Call] = []
    start = time.perf_counter()
    while not calls or time.perf_counter() - start < seconds:
        calls.append(driver.call())
    return calls


def traced_call(driver, slots: int):
    """One more engine call with the device traced and its kernel
    launches' shapes recorded (retaken when the trace lost a counted
    launch), then one of ``slots`` requests (a slot-full: the host's ops
    slow a call about twice and make many records) with the host's ops
    traced too, whose idle gaps the breakdown names.  Returns (device
    trace, launches, host trace)."""
    with program.recording_launches() as rec:
        def one():
            rec.qmatmul.clear()
            rec.ssd_scan.clear()
            driver.call()

        def expect():
            counts = {rooflines.SSD_KERNEL: len(rec.ssd_scan)}
            for path, kernel in rooflines.QMATMUL_KERNEL.items():
                counts[kernel] = sum(r["path"] == path for r in rec.qmatmul)
            return counts
        tr = profiling.trace(one, expect)
        launches = program.Launches(list(rec.qmatmul), list(rec.ssd_scan))
        labels = profiling.trace(lambda: driver.call(slots), host=True)
    return tr, launches, labels


def served(calls: List[Call]) -> List[check.Served]:
    out = []
    for c in calls:
        by_uid = {r.uid: r for r in c.requests}
        for d in c.done:
            out.append(check.Served(by_uid[d.uid].prompt, d.tokens))
    return out


@dataclasses.dataclass
class Session:
    """A cell set up: its files, the drawn weights and the program's
    driver (engine, params) with every shape warmed up."""
    cell: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    drawn: Any
    driver: Any

    @property
    def model(self) -> Dict[str, Any]:
        return self.config["model"]


def open_session(bench: Manifest, name: str, seed: int,
                 device: torch.device, t0: float) -> Session:
    """Set-up: the weights drawn on the device, the program's own
    derivation of its parameters, the engine, every shape of the mix run
    once."""
    cell = bench.cell(name)
    workload = bench.load_json(f"perfbench/workloads/{name}.json")
    config = bench.load_json(bench.config(cell["config"])["file"])
    cfg = program.program_config(config)
    api = program.model_api(cfg)
    at = time.perf_counter()
    drawn = program.weights(cfg, seed, device)
    params = program.params(cfg, drawn)
    _sync(device)
    at = log("weights drawn and quantized", at)
    gen = traffic.Generator(workload["traffic"], config["model"]["vocab"],
                            seed)
    drivers = importlib.import_module(
        f"perfbench.drivers.{workload['traffic']['driver']}")
    driver = drivers.Driver(api, params, workload["traffic"], gen, seed,
                            device)
    driver.warm_up()
    _sync(device)
    log("warm-up", at)
    return Session(cell, workload, config, drawn, driver)


def free_program(sess: Session, device: torch.device) -> None:
    """Drop the engine, the program's parameters and every held leaf."""
    sess.driver.close()
    sess.driver = None
    sess.drawn.drop_all()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def compare(sess: Session, items: List[check.Served], device: torch.device,
            control: bool = False):
    """The reference's gaps of the served tokens of ``items`` (and with
    ``control`` the control's), leaves drawn again as the reference reads
    them."""
    ref = importlib.import_module(
        f"perfbench.reference.{sess.config['family']}")
    rc.set_exact()
    get, model = sess.drawn.get, sess.model

    def sides(prec):
        return (lambda t: ref.hidden(get, model, prec, t),
                lambda x, r, c: rc.logits_at(get, prec, x, r, c))
    quant = model.get("quant")
    hidden, logits = sides(rc.Precision(quant))
    out = check.gaps(hidden, logits, items, int(sess.workload["check"]
                                                 ["block"]), device,
                     sides(rc.Precision(quant, control=True))
                     if control else None)
    sess.drawn.drop_all()
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t0: float) -> Dict[str, Any]:
    """Run cell ``name`` once; ``t0`` is the process's start
    (``perf_counter``).  Returns the result line's fields."""
    bench = Manifest(Path(root))
    sess = open_session(bench, name, seed, device, t0)
    setup_s = time.perf_counter() - t0
    at = time.perf_counter()

    # -- the measured window, then (traced runs) one more call traced.
    calls = measure(sess.driver, seconds)
    window_s = calls[-1].end_s - calls[0].start_s
    at = log(f"window ({len(calls)} calls: "
             f"{', '.join(f'{c.end_s - c.start_s:.3f}' for c in calls)} s)",
             at)
    tr = rec = labels = None
    if trace:
        tr, rec, labels = traced_call(
            sess.driver, int(sess.workload["traffic"]["slots"]))
        at = log("traced call", at)
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # -- the comparison, after the program's state is freed.
    attempted = sum(len(c.requests) for c in calls)
    want = {r.uid: r.max_new_tokens for c in calls for r in c.requests}
    finished = sum(len(d.tokens) == want[d.uid] for c in calls for d in c.done)
    items = check.sample(served(calls), int(sess.workload["check"]["sample"]),
                         seed)
    free_program(sess, device)
    per_request, _ = compare(sess, items, device)
    at = log("reference", at)
    limits = {k: float(v)
              for k, v in sess.workload["check"]["limits"].items()}
    nums = check.numbers(per_request)
    failed = attempted - finished

    # -- metrics by name.
    run = Run(cell=name, workload=sess.workload, model=sess.model,
              work=importlib.import_module(
                  f"perfbench.work.{sess.config['family']}"),
              calls=calls, window_s=window_s, setup_s=setup_s, trace=tr,
              launches=rec)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(kind, name):
        value = _metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(sess.cell["chips"]), "memory_peak_bytes": int(peak)}
    ok = failed == 0 and all(nums[k] is not None and nums[k] <= lim
                             for k, lim in limits.items())
    out: Dict[str, Any] = {"correct": ok,
                           "attempted": attempted, "failed": failed,
                           "metrics": metrics, "device": dev}
    if tr is not None:
        busy, win = profiling.busy_and_window(tr)
        dev["busy_s"], dev["window_s"] = busy, win
        out["breakdown"] = profiling.breakdown(tr, labels)
    flat = [g for r in per_request for g in r]
    out["compared_tokens"] = len(flat)
    out["widest_gap"] = max(flat) if flat else None
    out["check"] = {k: {"value": nums[k], "limit": lim}
                    for k, lim in limits.items()}
    return out
