"""The share of the traced call in which no operation ran on the card:
1 - (union of the device records' intervals) / the call's length, in %."""

from perfbench.lib import rooflines


def read(run):
    return rooflines.idle(run)
