"""Mean prefill time of the window's waves (``Completion.prefill_s`` of the
wave engine: the prefill and the first token read back), in ms."""

from perfbench.lib import spans


def read(run):
    s = spans.wave_prefill_s(run)
    return None if s is None else 1e3 * s
