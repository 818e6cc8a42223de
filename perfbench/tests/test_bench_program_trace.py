"""The readings of the program's own spans (``lib/program_trace.py``) against
hand counts, on hand-built spans and device intervals: the anchor mapping,
the idle split and its sum, shares that count only spans nested in their
parent, occupancy."""

from __future__ import annotations

import pytest

from perfbench.lib import profiling, program_trace as pt

# perf_counter 0 ns is wall 1,000,000 ns; the wall clock runs 1% fast, so a
# perf reading of p ns maps to 1000 + 1.01 p / 1000 µs.
ANCHORS = [(0, 1_000_000), (100_000_000, 102_000_000)]


def wall(us_from_start):
    """The perf_counter_ns reading that maps to 1000 + ``us`` µs."""
    return us_from_start * 1e3 / 1.01


def span(i, name, start_us, end_us, parent=None, device_ms=None, uid=None):
    return {"name": name, "id": i, "parent": parent, "uid": uid,
            "start_ns": wall(start_us), "end_ns": wall(end_us),
            "device_ms": device_ms}


def doc(spans, counters=None):
    return {"spans": spans, "counters": counters or {}, "anchors": ANCHORS}


def test_anchor_mapping_interpolates():
    assert pt.wall_us(ANCHORS, 0) == 1000.0
    assert pt.wall_us(ANCHORS, 100_000_000) == 102_000.0
    assert pt.wall_us(ANCHORS, 50_000_000) == pytest.approx(51_500.0)
    s = span(0, "x", 10, 30)
    assert pt.span_us(doc([s]), s) == (pytest.approx(1010.0),
                                       pytest.approx(1030.0))


def call():
    """engine.serve over 1000..1100 µs; model.forward over 1020..1050 and
    1070..1080; engine.step around each forward."""
    return doc([
        span(0, "engine.serve", 0, 100),
        span(1, "engine.step", 15, 55, parent=0, device_ms=0.04),
        span(2, "model.forward", 20, 50, parent=1),
        span(3, "engine.step", 65, 85, parent=0, device_ms=0.02),
        span(4, "model.forward", 70, 80, parent=3),
    ])


def test_idle_split_inside_straddling_and_outside_the_model():
    # device busy 1000-1010, 1030-1060, 1075-1100: gaps 1010-1030 (10 µs
    # in the engine, then 10 in the forward), 1060-1075 (10 in the engine,
    # then 5 in the second forward)
    device = [(990.0, 1010.0), (1030.0, 1045.0), (1040.0, 1060.0),
              (1075.0, 1100.0)]
    engine, model, length = pt.idle_split(call(), device)
    assert length == pytest.approx(100.0)
    assert model == pytest.approx(10.0 + 5.0)
    assert engine == pytest.approx(10.0 + 10.0)
    r = pt.readings(call(), device)
    assert r["idle_in_model"] == pytest.approx(15.0)
    assert r["idle_in_engine"] == pytest.approx(20.0)
    # the two add up to the call's own idle share
    busy = profiling.union_seconds([(max(s, 1000.0), min(e, 1100.0))
                                    for s, e in device]) * 1e6
    assert r["idle_in_model"] + r["idle_in_engine"] == \
        pytest.approx(100.0 * (1.0 - busy / length))


def test_step_busy_is_the_union_of_records_inside_each_step():
    # steps over 1015..1055 and 1065..1085; device busy 990-1010,
    # 1030-1060 (two overlapping records), 1075-1100: 25 µs in the first
    # step, 10 in the second
    device = [(990.0, 1010.0), (1030.0, 1045.0), (1040.0, 1060.0),
              (1075.0, 1100.0)]
    assert pt.mean_busy_ms(call(), device, "engine.step") == \
        pytest.approx((25.0 + 10.0) / 2 / 1e3)
    assert pt.readings(call(), device)["step_busy_ms"] == \
        pytest.approx(0.0175)
    assert pt.mean_busy_ms(call(), device, "engine.admit") is None


def test_a_gap_straddling_the_forwards_end_splits():
    device = [(1000.0, 1040.0), (1060.0, 1100.0)]      # gap 1040-1060
    engine, model, _ = pt.idle_split(call(), device)
    assert (model, engine) == (pytest.approx(10.0), pytest.approx(10.0))


def test_an_idle_card_is_all_idle():
    engine, model, length = pt.idle_split(call(), [])
    assert model == pytest.approx(40.0)
    assert engine + model == pytest.approx(length)


def test_shares_count_only_spans_inside_their_parent():
    d = doc([
        span(0, "engine.serve", 0, 100),
        span(1, "engine.step", 10, 40, parent=0, device_ms=4.0),
        span(2, "model.forward", 11, 39, parent=1),
        span(3, "model.moe", 12, 20, parent=2, device_ms=1.0),
        span(4, "model.moe", 21, 30, parent=2, device_ms=2.0),
        span(5, "engine.admit", 50, 60, parent=0, device_ms=6.0, uid=9),
        span(6, "model.forward", 51, 59, parent=5),
        span(7, "model.moe", 52, 58, parent=6, device_ms=5.0),
        span(8, "model.linear", 53, 54, parent=6, device_ms=0.5),
        span(9, "engine.step", 70, 90, parent=0, device_ms=2.0),
    ])
    assert pt.device_share(d, "model.moe", "engine.step") == \
        pytest.approx(100.0 * 3.0 / 6.0)
    assert pt.device_share(d, "model.linear", "engine.prefill") is None
    assert pt.mean_device_ms(d, "engine.step") == pytest.approx(3.0)
    assert pt.mean_device_ms(d, "engine.admit") == pytest.approx(6.0)
    assert [s["id"] for s in pt.named(d, "model.moe", inside="engine.admit")
            ] == [7]
    r = pt.readings(d, [])
    assert set(r) == {"admit_ms", "step_device_ms", "step_busy_ms",
                      "moe_share", "idle_in_engine", "idle_in_model"}


def test_linear_share_of_the_prefill():
    d = doc([
        span(0, "engine.serve", 0, 100),
        span(1, "engine.prefill", 0, 50, parent=0, device_ms=10.0),
        span(2, "model.forward", 1, 49, parent=1),
        span(3, "model.linear", 2, 3, parent=2, device_ms=1.5),
        span(4, "model.linear", 4, 5, parent=2, device_ms=2.5),
        span(5, "model.forward", 60, 70, parent=0),
        span(6, "model.linear", 61, 62, parent=5, device_ms=9.0),
    ])
    assert pt.device_share(d, "model.linear", "engine.prefill") == \
        pytest.approx(40.0)


def test_occupancy_from_the_counters():
    d = doc([], {"engine.slot_steps": 160, "engine.active_slot_steps": 120})
    assert pt.occupancy(d) == pytest.approx(75.0)
    assert pt.occupancy(doc([])) is None
    assert pt.readings(doc([]), []) == {}
