"""``qmatmul``'s share of its roofline on its int8 ``wgmma`` path (M >= 64,
the prefill's projections) over the traced call: Σ
``qmatmul_shape_bound`` of those launches over Σ their device time, in %."""

from perfbench.lib import rooflines


def read(run):
    return rooflines.qmatmul(run, "tensor_cores")
