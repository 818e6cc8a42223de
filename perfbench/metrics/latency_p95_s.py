"""95th percentile, over every request completed in the window, of its
time in service: from the start of its admission prefill to its
retirement (``Completion.prefill_s + decode_s``, host clock)."""

from perfbench.lib.stats import percentile


def read(run):
    return percentile([d.prefill_s + d.decode_s
                       for c in run.calls for d in c.done], 95)
