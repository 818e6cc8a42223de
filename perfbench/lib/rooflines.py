"""Kernel rooflines and the device's idle share, from a traced call: each
recorded launch's least time (``bounds``) against the device time of its
record in the trace."""

from __future__ import annotations

from typing import Optional

from perfbench.lib import bounds, profiling

QMATMUL_KERNEL = {"tensor_cores": "qmatmul_kernel_tc",
                  "stream": "qmatmul_kernel_stream"}
SSD_KERNEL = "ssd_scan_kernel"


def _share(least_s: float, records) -> Optional[float]:
    spent = sum(e - s for s, e in records) / 1e6
    return 100.0 * least_s / spent if spent > 0 else None


def qmatmul(run, path: str) -> Optional[float]:
    """Σ ``qmatmul_shape_bound`` of the launches on ``path`` over Σ their
    records' device time, in %; None when the call made none or the
    trace does not hold one record per launch."""
    if run.trace is None:
        return None
    launches = [r for r in run.launches.qmatmul if r["path"] == path]
    records = run.trace.kernel_records(QMATMUL_KERNEL[path])
    if not launches or len(records) != len(launches):
        return None
    least = sum(bounds.qmatmul_shape_bound(r["m"], r["k"], r["n"])[0]
                for r in launches)
    return _share(least, records)


def ssd_scan(run) -> Optional[float]:
    """Σ ``ssd_bound`` of the ``ssd_scan`` launches over Σ their records'
    device time, in %."""
    if run.trace is None:
        return None
    launches = run.launches.ssd_scan
    records = run.trace.kernel_records(SSD_KERNEL)
    if not launches or len(records) != len(launches):
        return None
    return _share(sum(bounds.ssd_bound(**r)[0] for r in launches), records)


def idle(run) -> Optional[float]:
    """1 - (union of the device's busy intervals) / the traced call, %."""
    if run.trace is None:
        return None
    busy, window = profiling.busy_and_window(run.trace)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
