"""Generated tokens of every request completed in the window, over the
window's seconds (host clock)."""

from perfbench.lib.stats import rate


def read(run):
    return rate(sum(len(d.tokens) for c in run.calls for d in c.done),
                run.window_s)
