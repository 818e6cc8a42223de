"""``ssd_scan``'s share of its roofline over the traced wave: Σ
``ssd_bound`` of its launches over Σ their device time, in %."""

from perfbench.lib import rooflines


def read(run):
    return rooflines.ssd_scan(run)
