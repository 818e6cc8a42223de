"""Prompt tokens of every request completed in the window, over the
window's seconds (host clock; every engine call ends waiting for the card)."""

from perfbench.lib.stats import rate


def read(run):
    by_uid = {r.uid: len(r.prompt) for c in run.calls for r in c.requests}
    return rate(sum(by_uid[d.uid] for c in run.calls for d in c.done),
                run.window_s)
