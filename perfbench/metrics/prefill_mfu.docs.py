"""The least time of one wave's prefill at the chip's peaks (each product
at its operand type's peak, or its bytes at the memory's, whichever is
longer: ``perfbench/work/<family>.py``) over the wave's measured prefill
(``wave_prefill_ms.docs``), in %."""

from perfbench.lib import spans


def read(run):
    s = spans.wave_prefill_s(run)
    if s is None:
        return None
    t = run.workload["traffic"]
    least = run.work.prefill_least_s(run.model, int(t["slots"]),
                                     int(t["prompt_len"]["fixed"]))
    return 100.0 * least / s
