"""The yardstick's arithmetic against hand counts: rates and percentiles
over every request, the frozen bound functions at one shape each, and the
device's busy time as the union of its intervals."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.lib import bounds, profiling, stats, traffic


def test_rate_is_all_work_over_all_time():
    assert stats.rate(65_536 * 3, 1.5) == 131_072.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_p95_interpolates_between_ranks_over_every_value():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    # order does not matter; the tail is of all values, not of chunks
    vals = [0.1] * 90 + [5.0] * 10
    assert stats.percentile(vals[::-1], 95) == pytest.approx(5.0)


def test_spread_is_iqr_over_median():
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)


def test_qmatmul_shape_bound_by_hand():
    t, by = bounds.qmatmul_shape_bound(64, 128, 256)
    moved = 64 * 128 + 128 * 256 + 4 * 256 + 4 * 64 * 256   # 107,520 B
    assert by == "bytes"
    assert t == pytest.approx(moved / 3.35e12)
    t, by = bounds.qmatmul_shape_bound(65_536, 1024, 4384)
    assert by == "bytes"
    assert t == pytest.approx((65_536 * 1024 + 1024 * 4384 + 4 * 4384
                               + 4 * 65_536 * 4384) / 3.35e12)


def test_ssd_flops_and_bound_by_hand():
    # two chunks of 64 at P 2, N 3: C Bᵀ 2 x 3·64·65; the rest 2 x 2·64·65
    # plus the state readout (second chunk) and two updates, 2·64·3·2 each
    cb, rest = bounds.ssd_flops(128, 64, 2, 3, True)
    assert cb == 2 * 3 * 64 * 65
    assert rest == 2 * 2 * 64 * 65 + 3 * (2 * 64 * 3 * 2)
    t, _ = bounds.ssd_bound(1, 128, 1, 2, 1, 3, "float32", 4 * 128 * 8, True)
    assert t == pytest.approx(max(3 * (cb + rest) / 495e12,
                                  (4 * 128 * 8 + 4 * (128 + 1 + 128 * 2)
                                   + 4 * 2 * 3) / 3.35e12))
    t_bf, _ = bounds.ssd_bound(8, 1024, 32, 64, 1, 128, "bfloat16",
                               2 * 8 * 1024 * (2048 + 256), True)
    # the kernel table's figure for this shape (PERF.md): 0.0402 ms
    assert t_bf * 1e3 == pytest.approx(0.0402, rel=2e-2)


def test_busy_is_the_union_of_intervals():
    assert profiling.union_seconds([(0, 10), (5, 15), (20, 30)]) == \
        pytest.approx(25e-6)
    assert profiling.union_seconds([(0, 10), (2, 3)]) == pytest.approx(1e-5)
    assert profiling.gaps([(0, 10), (5, 15), (20, 30)], (0, 40)) == \
        [(15, 20), (30, 40)]
    tr = profiling.Trace(device=[("k", 0, 10), ("k", 5, 15), ("c", 20, 30)],
                         window_s=4e-5, host=[("aten::mm", 14, 25)],
                         window=(0, 40))
    busy, window = profiling.busy_and_window(tr)
    assert (busy, window) == (pytest.approx(25e-6), pytest.approx(40e-6))
    bd = profiling.breakdown(tr, tr)
    assert bd["device_ops"][0] == ["k", pytest.approx(20e-6)]
    assert dict(map(tuple, bd["idle_gaps"])) == {
        "aten::mm": pytest.approx(5e-6), "python": pytest.approx(10e-6)}


def test_traffic_levels_give_every_seed_the_same_work():
    spec = {"log_uniform": [64, 513]}
    lv = traffic.levels(spec)
    assert len(lv) == traffic.LEVELS == 16
    assert 64 < min(lv) and max(lv) < 513
    assert traffic.levels({"uniform": [0, 160]}) == list(range(5, 160, 10))
    assert traffic.levels({"log_uniform": [32, 512]})[7:9] == [117, 140]
    t = {"backlog": 64, "prompt_len": spec,
         "new_tokens": {"log_uniform": [32, 512]}}
    a, b = traffic.Generator(t, 1000, 1), traffic.Generator(t, 1000, 2 ** 33)
    ra, rb, ra2 = a.batch(), b.batch(), a.batch()
    # every seed and every call: the same lengths in the same order ...
    shape = [(len(r.prompt), r.max_new_tokens) for r in ra]
    assert shape == [(len(r.prompt), r.max_new_tokens) for r in rb]
    assert shape == [(len(r.prompt), r.max_new_tokens) for r in ra2]
    assert sorted(p for p, _ in shape) == sorted(np.repeat(lv, 4))
    # ... and other tokens
    assert not np.array_equal(ra[0].prompt, rb[0].prompt)
    assert not np.array_equal(ra[0].prompt, ra2[0].prompt)
