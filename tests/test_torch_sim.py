"""The port's numpy plant simulator and scenario fleets against ``repro.sim``:
the same seeds must give byte-equal traces, datasets and fleet readings."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.sim import msf as jmsf
from repro.sim import scenarios as jscenarios
from repro_torch.sim import msf as tmsf
from repro_torch.sim import scenarios as tscenarios

torch.set_num_threads(1)


def assert_bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("attack_id", (0, 4, 6))
def test_simulate_byte_equal(attack_id):
    kw = dict(attack_id=attack_id, attack_start=120 if attack_id else None,
              seed=3)
    want = jmsf.simulate(300, **kw)
    got = tmsf.simulate(300, **kw)
    for field in dataclasses.fields(want):
        assert_bytes_equal(getattr(got, field.name),
                           getattr(want, field.name))


def test_simulate_with_drift_and_events_byte_equal():
    def run(m):
        drift = m.ParamDrift({"k_flash": -0.08, "t_sea": 0.04},
                             start=50, ramp=100)
        events = [m.AttackEvent(1, start=80, duration=40, intensity=1.5),
                  m.AttackEvent(5, start=150)]
        return m.simulate(250, seed=9, events=events, drift=drift)

    want, got = run(jmsf), run(tmsf)
    for field in dataclasses.fields(want):
        assert_bytes_equal(getattr(got, field.name),
                           getattr(want, field.name))


def test_build_dataset_byte_equal():
    kw = dict(window=40, stride=7, normal_cycles=400, attack_cycles=250,
              seed=1, jitter=0.01, jitter_plants=2)
    wx, wy = jmsf.build_dataset(**kw)
    gx, gy = tmsf.build_dataset(**kw)
    assert_bytes_equal(gx, wx)
    assert_bytes_equal(gy, wy)


@pytest.mark.parametrize("names", (None, ("baseline", "tb0-spoof",
                                          "seasonal-drift")))
def test_fleet_readings_byte_equal(names):
    want = jscenarios.fleet_readings(5, 120, names=names, seed=2)
    got = tscenarios.fleet_readings(5, 120, names=names, seed=2)
    assert_bytes_equal(got, want)


def test_scenario_table_matches():
    assert list(tscenarios.SCENARIOS) == list(jscenarios.SCENARIOS)
    for name, want in jscenarios.SCENARIOS.items():
        got = tscenarios.SCENARIOS[name]
        assert (got.description, got.jitter, got.onset, got.families) == \
            (want.description, want.jitter, want.onset, want.families)
        assert [dataclasses.astuple(e) for e in got.events] == \
            [dataclasses.astuple(e) for e in want.events]
        assert (got.drift is None) == (want.drift is None)
        if want.drift is not None:
            assert dataclasses.astuple(got.drift) == \
                dataclasses.astuple(want.drift)
    assert tscenarios.scenario_table() == jscenarios.scenario_table()
    fleet = tscenarios.build_fleet(n_plants=4, seed=1)
    assert [s.name for s in fleet] == \
        [s.name for s in jscenarios.build_fleet(n_plants=4, seed=1)]
