"""Serving time per decode step of the continuous engine, in ms: the
window's ``ServeStats.wall_s`` less the admission spans
(``Completion.prefill_s``), over ``ServeStats.steps``.  An admission's
span ends when its kernels are queued (nothing waits for the card there),
so its device time lands in the step that follows and is counted here."""

from perfbench.lib import spans


def read(run):
    s = spans.step_s(run)
    return None if s is None else 1e3 * s
