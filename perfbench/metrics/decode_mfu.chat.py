"""One decode step's roofline time (every held weight, state and cache
read once and the state written once at 3.35 TB/s, or its products at
their peaks, whichever is longer: ``perfbench/work/<family>.py``) over
``step_ms.chat``, in %."""

from perfbench.lib import spans


def read(run):
    s = spans.step_s(run)
    if s is None:
        return None
    t = run.workload["traffic"]
    return 100.0 * run.work.decode_roofline_s(
        run.model, int(t["slots"]), int(t["cache_len"])) / s
