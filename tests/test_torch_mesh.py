"""The port's fleet meshes on CPU gloo ranks, against the JAX package's
unsharded engines: the counterparts of ``test_sharded_streams.py`` and
``test_model_mesh.py``.

One module-scoped fixture spawns four gloo ranks
(``repro_torch.launch.mesh.spawn``) that serve every case below on its mesh
(a mesh takes a prefix of the four ranks) and return what each rank saw;
each test asserts its own case.  The same cases run unsharded in this
process, through the reference's ``StreamEngine``/``GroupedStreamEngine``
(``shard=False``) and through the port's, with params carried across by
``repro_torch.bridge``.  The ranks import this module to unpickle the rank
function, so the JAX side is imported only inside the functions this process
runs.

Tolerances:

* Against the reference's unsharded engine: verdict labels, streams, cycles
  and groups equal; probabilities, scores and thresholds within
  ``test_torch_serving.OUT_TOL`` (the reference's jitted step contracts the
  requantize into an FMA and sums means in another order), INT within
  ``test_torch_core.TOL["INT"]`` (a last-bit difference can move an int16
  activation code a step).
* Against the port's own unsharded engine: SINT outputs ``torch.equal``;
  REAL, INT and DINT within 1e-6 relative (a shard's GEMM has fewer rows and
  may sum in another order).
* Every rank of a mesh returns the same verdicts, bit for bit.
"""

import concurrent.futures
import traceback

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.serving import GroupedStreamEngine, ModelGroup, StreamEngine
from repro_torch.serving import core as tcore

SCHEMES = ("REAL", "SINT", "INT", "DINT")
WORLD = 4
# (data-axis ranks, streams): every width with a fleet it divides and one
# it does not (the pad-stream contract), as test_sharded_streams.
DEVICE_FLEETS = ((1, 3), (2, 4), (2, 5), (4, 8), (4, 6), (4, 3))
FLEET_IDS = ("d1-s3", "d2-s4", "d2-s5-pad", "d4-s8", "d4-s6-pad",
             "d4-s3-pad")
SELF_RTOL = 1e-6
NO_NORM = dict(norm_mean=(0.0, 0.0), norm_std=(1.0, 1.0))


# ---------------------------------------------------------------------------
# What a rank runs (and this process, with no mesh, for the unsharded twin)


def _key(v):
    return (v.stream, v.cycle, v.pred, v.prob, v.score, v.threshold, v.group)


def _engine(case, mesh):
    kw = dict(case["kw"], device="cpu")
    if mesh is not None:
        kw["mesh"] = mesh
    if case["kind"] != "grouped":
        return StreamEngine(case["model"],
                            params_from_numpy(case["params"], device="cpu"),
                            **kw)
    return GroupedStreamEngine(
        [ModelGroup(name, model, params_from_numpy(p, device="cpu"), n, head,
                    fused, adapt)
         for name, model, p, n, head, fused, adapt in case["groups"]], **kw)


def _serve(case, mesh, calls):
    """Serve ``case`` on ``mesh`` (None: unsharded): every verdict batch
    with its outputs, the stats and the gathers this rank made, by axis."""
    eng = _engine(case, mesh)
    if case.get("warmup"):
        eng.warmup()
    del calls[:]
    batches = []
    readings = case["readings"]
    for c in range(readings.shape[0]):
        got = eng.ingest(readings[c])
        if got:
            batches.append((c, [_key(v) for v in got],
                            {k: o.copy() for k, o in eng.last_outputs.items()}))
    tail = eng.flush()
    if tail:
        batches.append((readings.shape[0], [_key(v) for v in tail],
                        {k: o.copy() for k, o in eng.last_outputs.items()}))
    st = eng.stats
    return {
        "batches": batches, "steps": st.steps, "windows": st.windows,
        "cycles": st.cycles, "dispatches": st.dispatches,
        "collectives": dict(st.collectives),
        "gathers": {"model": sum(g is eng._model_group for g in calls
                                 if g is not None),
                    "data": sum(g is eng._data_group for g in calls
                                if g is not None)},
        "n_shards": eng.n_shards, "model_shards": eng.model_shards,
        "in_mesh": eng._in_mesh,
        "rows": [r.shape[0] for r in eng._rings],
        "fused": getattr(eng, "fused", None),
        "shard_streams": getattr(eng, "shard_streams", None),
        "live": [u.live_threshold for u in eng._units],
        "mega": eng._mega,
    }


def _raises(fn):
    """The exception ``fn()`` raises, as (type name, message); None when it
    returns."""
    try:
        fn()
    except Exception as e:                  # the case asserts which
        return type(e).__name__, str(e)
    return None


def _checks(case, meshes, calls):
    """The constructor contracts and the mesh functions, on every rank (the
    rejected meshes are built collectively, before any engine sees them)."""
    eng = lambda mesh, **kw: _engine(dict(case, kw=dict(case["kw"], **kw)),
                                     mesh)
    from torch.distributed.device_mesh import DeviceMesh
    no_data = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("model",))
    wide_pod = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "pod"))
    host = tmesh.make_host_mesh(device_type="cpu")
    out = {
        "shard_false_mesh": _raises(lambda: eng(meshes[(2, 1)],
                                                shard=False)),
        "no_data_axis": _raises(lambda: eng(no_data)),
        "wide_pod_axis": _raises(lambda: eng(wide_pod)),
        "fused_true_model_mesh": _raises(lambda: eng(meshes[(1, 2)],
                                                     fused=True)),
        "model_shards_0": _raises(
            lambda: tmesh.make_fleet_mesh(1, model_shards=0,
                                          device_type="cpu")),
        "too_many_2d": _raises(
            lambda: tmesh.make_fleet_mesh(WORLD, model_shards=2,
                                          device_type="cpu")),
        "too_many_1d": _raises(
            lambda: tmesh.make_fleet_mesh(WORLD + 1, device_type="cpu")),
        "zero_1d": _raises(
            lambda: tmesh.make_fleet_mesh(0, device_type="cpu")),
        "production": _raises(
            lambda: tmesh.make_production_mesh(device_type="cpu")),
    }
    shapes = {}
    for name, fn in (
            ("d1", lambda: tmesh.make_fleet_mesh(1, device_type="cpu")),
            ("d1m2", lambda: tmesh.make_fleet_mesh(1, model_shards=2,
                                                   device_type="cpu")),
            ("m2", lambda: tmesh.make_fleet_mesh(model_shards=2,
                                                 device_type="cpu")),
            ("all", lambda: tmesh.make_fleet_mesh(device_type="cpu")),
            ("host", lambda: host)):
        m = fn()
        shapes[name] = (tuple(m.mesh_dim_names), tuple(m.shape),
                        tmesh.data_axes(m))
    out["shapes"] = shapes
    # The detector on the host mesh and on a model mesh: fused or not.
    det = dict(case, kw={"n_streams": 4}, model=case["det_model"],
               params=case["det_params"])
    on_host = _engine(det, host)
    on_model = _engine(det, meshes[(1, 2)])
    out["host"] = (on_host.n_shards, on_host.model_shards, on_host.fused,
                   on_host._in_mesh)
    out["model_fused"] = on_model.fused if on_model._in_mesh else None
    # One step of the classifier, and of a narrow model, on the model mesh:
    # the gathers inside the step.
    for name, sub in (("one_step", det), ("narrow_step", case)):
        e = _engine(sub, meshes[(1, 2)])
        if not e._in_mesh:
            out[name] = None
            continue
        ring = torch.zeros_like(e._ring)
        block = torch.zeros((e.shard_streams, e.stride, 2))
        del calls[:]
        y = e._step(ring, block, 0)
        out[name] = (tuple(y.shape), sum(g is e._model_group for g in calls),
                     sum(g is e._data_group for g in calls))
    return out


MESH_SHAPES = ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))


def _rank_cases(rank, world, cases):
    """One rank: build every mesh (collectively, in one order), then serve
    each case; a case that raises returns its traceback for its test."""
    torch.set_num_threads(1)
    meshes = {(d, m): tmesh.make_fleet_mesh(d, model_shards=m,
                                            device_type="cpu")
              for d, m in MESH_SHAPES}
    calls = []
    gather = tcore._gather

    def recording(t, group, size):
        calls.append(group)
        return gather(t, group, size)

    tcore._gather = recording
    out = {}
    for case in cases:
        try:
            if case["kind"] == "checks":
                out[case["name"]] = _checks(case, meshes, calls)
            else:
                mesh = None if case["mesh"] is None else meshes[case["mesh"]]
                out[case["name"]] = _serve(case, mesh, calls)
        except Exception:
            out[case["name"]] = {"error": traceback.format_exc()}
    return out


# ---------------------------------------------------------------------------
# The cases, built from the reference's test models (this process only)


def _np(params):
    import jax
    return jax.tree_util.tree_map(np.asarray, params)


def _stream_case(name, mesh, jm, jp, readings, **kw):
    from test_torch_grouped import port_head, port_model
    if "head" in kw and kw["head"] is not None:
        kw["jhead"], kw["head"] = kw["head"], port_head(kw["head"])
    return {"name": name, "kind": "stream", "mesh": mesh, "jmodel": jm,
            "jparams": jp, "model": port_model(jm), "params": _np(jp),
            "readings": readings,
            "kw": {k: v for k, v in kw.items() if k != "jhead"},
            "jkw": {k: (kw["jhead"] if k == "head" else v)
                    for k, v in kw.items() if k != "jhead"}}


def _grouped_case(name, mesh, jgroups, readings, adapt=None, **kw):
    from test_torch_grouped import port_head, port_model
    adapt = adapt or {}
    return {"name": name, "kind": "grouped", "mesh": mesh,
            "jgroups": jgroups, "readings": readings,
            "groups": [(g.name, port_model(g.model), _np(g.params),
                        g.n_streams,
                        None if g.head is None else port_head(g.head), g.fused,
                        adapt.get(g.name)) for g in jgroups],
            "kw": dict(kw), "jkw": {k: v for k, v in kw.items()
                                    if k not in ("megakernel",)}}


def _build_cases():
    import dataclasses
    import functools

    from repro.serving.core import AdaptConfig as JAdaptConfig
    from repro.sim import ReconstructionHead as JReconstructionHead
    from repro.sim import fleet_readings
    from repro.sim import heads as jheads
    from repro_torch.serving import AdaptConfig
    from test_drift import energy_detector
    from test_fused import detector_params, small_detector
    from test_grouped import mixed_groups
    from test_streams import identity_probe

    # Built once each: the full detector's quantization runs JAX.
    detector_params = functools.lru_cache(maxsize=None)(detector_params)
    mixed_groups = functools.lru_cache(maxsize=None)(mixed_groups)
    cases = []
    small = dict(n_features=2, window=4, stride=3)
    for d, s in DEVICE_FLEETS:
        for scheme in SCHEMES:
            jm, jp = small_detector(scheme, seed=d + s)
            cases.append(_stream_case(
                f"grid-{scheme}-d{d}-s{s}", (d, 1), jm, jp,
                fleet_readings(s, 30, seed=17 * d + s), n_streams=s,
                **small))
        jm, jp = small_detector("REAL", seed=0)
        case = _stream_case(f"pad-d{d}-s{s}", (d, 1), jm, jp,
                            fleet_readings(s, 10, seed=3), n_streams=s,
                            n_features=2, window=4, stride=2)
        case["no_reference"] = True
        cases.append(case)
    for scheme in ("REAL", "SINT"):
        jm, jp = detector_params(scheme, seed=1)
        cases.append(_stream_case(
            f"wrap-{scheme}", (4, 1), jm, jp, fleet_readings(6, 430, seed=11),
            n_streams=6, window=200, stride=10))
    jm, jp = small_detector("SINT", seed=2)
    case = _stream_case("warmup", (4, 1), jm, jp,
                        fleet_readings(5, 12, seed=5), n_streams=5, **small)
    case["warmup"] = True
    cases.append(case)
    jm, jp = small_detector("REAL", seed=0)
    for name, n, shard in (("auto", 2, None), ("auto-forced", 3, True)):
        case = _stream_case(name, None, jm, jp, fleet_readings(n, 10, seed=4),
                            n_streams=n, shard=shard, **small)
        case["rank_only"] = True
        cases.append(case)
    case = _stream_case("async", (4, 1), *small_detector("SINT", seed=3),
                        fleet_readings(6, 24, seed=7), n_streams=6,
                        async_depth=1, **small)
    cases.append(case)

    # 2-D meshes: the 400-64-32-16-2 classifier's 64-wide first layer is
    # column-sharded over "model".
    for scheme in SCHEMES:
        jm, jp = detector_params(scheme)
        cases.append(_stream_case(f"model2-{scheme}", (1, 2), jm, jp,
                                  fleet_readings(3, 230, seed=11),
                                  n_streams=3))
    for scheme in ("REAL", "SINT"):
        jm, jp = detector_params(scheme)
        for n in (4, 5):
            cases.append(_stream_case(f"data2model2-{scheme}-s{n}", (2, 2),
                                      jm, jp, fleet_readings(n, 230, seed=13),
                                      n_streams=n))
    jm, jp = identity_probe(32, 2)
    case = _stream_case(
        "identity", (1, 2), jm, jp, np.random.default_rng(3).normal(
            size=(70, 3, 2)).astype(np.float32), n_streams=3, n_features=2,
        window=32, stride=5, **NO_NORM)
    case["no_reference"] = True
    cases.append(case)
    jm, jp = energy_detector(32, 2)
    cases.append(_stream_case(
        "adaptive", (1, 2), jm, jp, np.random.default_rng(7).normal(
            size=(80, 3, 2)).astype(np.float32), n_streams=3, n_features=2,
        window=32, stride=4, head=JReconstructionHead(threshold=0.8,
                                                      target_fpr=0.1),
        adapt=True, **NO_NORM))
    from repro.serving import ModelGroup as JModelGroup
    det_m, det_p = small_detector("SINT", seed=1)
    ae_m, ae_p = energy_detector(32, 2)
    cases.append(_grouped_case(
        "grouped-model", (1, 2),
        [JModelGroup("det", det_m, det_p, 3),
         JModelGroup("ae", ae_m, ae_p, 2,
                     head=JReconstructionHead(threshold=2.0))],
        fleet_readings(5, 70, seed=21), n_features=2, stride=5))
    jm, jp = small_detector("REAL", seed=0)
    case = _stream_case("checks", None, jm, jp, None, n_streams=4, **small)
    cm, cp = detector_params("SINT")
    case.update(kind="checks", det_model=_stream_case(
        "", None, cm, cp, None)["model"], det_params=_np(cp))
    cases.append(case)

    # Grouped fleets on data meshes: per group by default, one grouped
    # launch a step with megakernel=True.
    readings8 = np.random.default_rng(0).normal(size=(30, 8, 2)) \
        .astype(np.float32)
    for scheme in ("REAL", "SINT"):
        for d in (2, 4):
            for mode in ("per_group", "mega"):
                kw = dict(n_features=2, stride=3, **NO_NORM)
                if mode == "mega":
                    kw["megakernel"] = True
                cases.append(_grouped_case(
                    f"grouped-{scheme}-d{d}-{mode}", (d, 1),
                    mixed_groups(scheme), readings8, **kw))
    jgroups = list(mixed_groups("SINT"))
    jgroups[1] = dataclasses.replace(
        jgroups[1], head=jheads.ReconstructionHead(threshold=0.25,
                                                   target_fpr=0.2),
        adapt=JAdaptConfig(min_count=4))
    readings8b = np.random.default_rng(1).normal(size=(30, 8, 2)) \
        .astype(np.float32)
    for mode, extra in (("per_group", {}), ("mega", {"megakernel": True}),
                        ("mega-async", {"megakernel": True,
                                        "async_depth": 1})):
        cases.append(_grouped_case(
            f"grouped-adaptive-{mode}", (2, 1), jgroups, readings8b,
            adapt={"ae": AdaptConfig(min_count=4)}, n_features=2, stride=3,
            **NO_NORM, **extra))
    return cases


def _ref_key(case):
    """Cases that differ only in their mesh or their port-only knobs share
    one reference run."""
    model = case.get("jgroups") or case["jmodel"]
    return (id(model), id(case.get("jparams")), id(case["readings"]),
            repr(sorted(case["jkw"].items())))


def _reference(case):
    """The reference's unsharded engine over the case: its verdict keys and
    last outputs per batch."""
    from repro.serving import GroupedStreamEngine as JGroupedStreamEngine
    from repro.serving import StreamEngine as JStreamEngine
    if case["kind"] == "stream":
        eng = JStreamEngine(case["jmodel"], case["jparams"], shard=False,
                            **case["jkw"])
    else:
        eng = JGroupedStreamEngine(case["jgroups"], shard=False,
                                   **case["jkw"])
    batches = []
    readings = case["readings"]
    for c in range(readings.shape[0]):
        got = eng.ingest(readings[c])
        if got:
            batches.append((c, [_key(v) for v in got],
                            {k: np.asarray(o).copy()
                             for k, o in eng.last_outputs.items()}))
    tail = eng.flush()
    if tail:
        batches.append((readings.shape[0], [_key(v) for v in tail],
                        {k: np.asarray(o).copy()
                         for k, o in eng.last_outputs.items()}))
    return batches


@pytest.fixture(scope="module")
def runs():
    """{case name: {"ranks": [per-rank result], "ref": reference batches,
    "plain": the port's unsharded result, "case": the case}}."""
    cases = _build_cases()
    rank_cases = [{k: v for k, v in c.items()
                   if k not in ("jmodel", "jparams", "jgroups", "jkw")}
                  for c in cases]
    # The ranks serve while this process runs the unsharded engines.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(tmesh.spawn, _rank_cases, WORLD, "gloo",
                              rank_cases, timeout=600.0)
        out, refs = {}, {}
        for case, rc in zip(cases, rank_cases):
            entry = out[case["name"]] = {"case": case}
            if case["kind"] == "checks" or case.get("rank_only"):
                continue
            entry["plain"] = _serve(dict(rc, mesh=None), None, [])
            if not case.get("no_reference"):
                key = _ref_key(case)
                if key not in refs:
                    refs[key] = _reference(case)
                entry["ref"] = refs[key]
        ranks = pending.result()
    for name, entry in out.items():
        entry["ranks"] = [r[name] for r in ranks]
    return out


# ---------------------------------------------------------------------------
# Assertions


def _members(entry):
    """The results of the ranks inside the case's mesh (errors raise)."""
    for r in entry["ranks"]:
        if "error" in r:
            pytest.fail(r["error"])
    got = [r for r in entry["ranks"] if r["in_mesh"]]
    assert got
    return got


def _same_across_ranks(results):
    first = results[0]["batches"]
    for r in results[1:]:
        assert [(c, keys) for c, keys, _ in r["batches"]] == \
            [(c, keys) for c, keys, _ in first]
        for (_, _, a), (_, _, b) in zip(r["batches"], first):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _ref_tol(scheme):
    from test_torch_core import TOL
    from test_torch_serving import OUT_TOL
    return TOL["INT"] if scheme == "INT" else OUT_TOL


def _match_reference(got, want, scheme):
    """Verdict for verdict against the reference's unsharded engine."""
    tol = _ref_tol(scheme)
    assert len(got) == len(want) > 0
    for (_, gk, go), (_, wk, wo) in zip(got, want):
        assert [k[:3] + k[6:] for k in gk] == [k[:3] + k[6:] for k in wk]
        for g, w in zip(gk, wk):
            for a, b in zip(g[3:6], w[3:6]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(a, b, **tol)
        for k in wo:
            np.testing.assert_allclose(go[k], wo[k], **tol)


def _match_plain(got, want, scheme):
    """Against the port's own unsharded engine."""
    assert [[k[:3] + k[6:] for k in keys] for _, keys, _ in got] == \
        [[k[:3] + k[6:] for k in keys] for _, keys, _ in want]
    for (_, gk, go), (_, wk, wo) in zip(got, want):
        for k in wo:
            if scheme == "SINT":
                assert torch.equal(torch.from_numpy(go[k]),
                                   torch.from_numpy(wo[k]))
            else:
                np.testing.assert_allclose(go[k], wo[k], rtol=SELF_RTOL,
                                           atol=0)
        for g, w in zip(gk, wk):
            for a, b in zip(g[3:6], w[3:6]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(a, b, rtol=SELF_RTOL, atol=0)


def _parity(entry, scheme):
    got = _members(entry)
    _same_across_ranks(got)
    _match_reference(got[0]["batches"], entry["ref"], scheme)
    _match_plain(got[0]["batches"], entry["plain"]["batches"], scheme)
    return got


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("fleet", DEVICE_FLEETS, ids=FLEET_IDS)
def test_data_mesh_matches_unsharded_reference(runs, fleet, scheme):
    d, s = fleet
    got = _parity(runs[f"grid-{scheme}-d{d}-s{s}"], scheme)
    assert len(got) == d
    for r in got:
        assert r["n_shards"] == d and len(r["batches"]) >= 9  # ring wrapped
        # One fused launch and one data gather a step, no model gather.
        assert r["dispatches"] == r["steps"] == len(r["batches"])
        assert r["collectives"] == r["gathers"] == {"model": 0,
                                                    "data": r["steps"]}


@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_full_detector_wraparound_on_four_ranks(runs, scheme):
    """430 cycles wrap the 200-reading ring; 6 plants on 4 ranks pad."""
    got = _parity(runs[f"wrap-{scheme}"], scheme)
    assert len(got) == 4 and len(got[0]["batches"]) == 24
    assert [r["rows"] for r in got] == [[2]] * 4


@pytest.mark.parametrize("fleet", DEVICE_FLEETS, ids=FLEET_IDS)
def test_pad_streams_never_surface(runs, fleet):
    d, s = fleet
    pad = -(-s // d) * d
    for r in _members(runs[f"pad-d{d}-s{s}"]):
        assert r["shard_streams"] * r["n_shards"] == pad
        assert r["rows"] == [pad // d]
        assert [c for c, _, _ in r["batches"]] == [3, 5, 7, 9]
        for _, keys, outs in r["batches"]:
            assert outs[None].shape == (s, 2)
            assert [k[0] for k in keys] == list(range(s))
        assert r["windows"] == 4 * s and r["steps"] == 4


def test_windows_equal_naive_slicing_on_model_mesh(runs):
    """A 64-wide identity layer, column-sharded: the outputs are the
    windows themselves."""
    entry = runs["identity"]
    readings = entry["case"]["readings"]
    got = _members(entry)
    _same_across_ranks(got)
    for r in got:
        assert r["collectives"]["model"] == r["steps"] > 0
        for cycle, _, outs in r["batches"]:
            want = readings[cycle - 31:cycle + 1].transpose(1, 0, 2) \
                .reshape(3, -1)
            np.testing.assert_array_equal(outs[None], want)


def test_warmup_runs_the_sharded_shapes(runs):
    got = _parity(runs["warmup"], "SINT")
    for r in got:
        assert r["steps"] == 3
        # warmup's own gathers are not counted
        assert r["collectives"] == r["gathers"] == {"model": 0, "data": 3}


def test_async_on_four_ranks_matches_the_sync_reference(runs):
    got = _parity(runs["async"], "SINT")
    assert got[0]["steps"] == len(got[0]["batches"])


def test_auto_mesh_never_wider_than_the_fleet(runs):
    ranks = runs["auto"]["ranks"]
    assert [r.get("error") for r in ranks] == [None] * WORLD
    assert [r["n_shards"] for r in ranks] == [2] * WORLD
    assert [r["in_mesh"] for r in ranks] == [True, True, False, False]
    # Ranks outside the mesh count the cycles and emit nothing.
    assert [len(r["batches"]) for r in ranks] == [3, 3, 0, 0]
    assert [r["cycles"] for r in ranks] == [10] * WORLD
    _same_across_ranks(ranks[:2])
    forced = runs["auto-forced"]["ranks"]
    assert [r["n_shards"] for r in forced] == [3] * WORLD
    assert [r["in_mesh"] for r in forced] == [True] * 3 + [False]


@pytest.fixture(scope="module")
def checks(runs):
    for r in runs["checks"]["ranks"]:
        if "error" in r:
            pytest.fail(r["error"])
    return runs["checks"]["ranks"]


def test_shard_flag_and_mesh_validation(checks):
    for r in checks:
        assert r["shard_false_mesh"][0] == "ValueError"
        assert r["no_data_axis"] == (
            "ValueError", "fleet mesh needs a 'data' axis, got ('model',)")
        assert r["wide_pod_axis"][0] == "ValueError"
        assert "must have size 1" in r["wide_pod_axis"][1]
    # a ("data", "model") mesh serves while "model" has size 1
    assert checks[0]["host"] == (1, 1, True, True)
    assert [r["host"][3] for r in checks] == [True, False, False, False]


def test_mesh_shapes_and_errors(checks):
    for r in checks:
        assert r["shapes"] == {
            "d1": (("data",), (1,), ("data",)),
            "d1m2": (("data", "model"), (1, 2), ("data",)),
            "m2": (("data", "model"), (2, 2), ("data",)),
            "all": (("data",), (4,), ("data",)),
            "host": (("data", "model"), (1, 1), ("data",))}
        assert r["model_shards_0"][0] == "RuntimeError"
        assert "model_shards" in r["model_shards_0"][1]
        for name in ("too_many_2d", "too_many_1d", "zero_1d"):
            kind, msg = r[name]
            assert kind == "RuntimeError" and "fleet mesh" in msg
            assert "torch.distributed.run" in msg
        assert r["production"][0] == "RuntimeError"
        assert "needs 256 ranks" in r["production"][1]


def test_fused_true_rejected_on_model_mesh(checks):
    for r in checks:
        kind, msg = r["fused_true_model_mesh"]
        assert kind == "ValueError"
        assert "cannot serve on a model-sharded mesh" in msg


def test_fused_auto_resolves_per_layer_on_model_mesh(checks):
    assert [r["model_fused"] for r in checks] == [False, False, None, None]


def test_host_mesh_model_axis_of_one_keeps_fusion(checks):
    assert checks[0]["host"][2] is True


def test_one_model_gather_per_step(checks):
    """Only the 64-wide layer crosses MODEL_SHARD_MIN_WIDTH: one gather over
    "model" inside the step, none over "data"."""
    assert checks[0]["one_step"] == ((4, 2), 1, 0)
    assert checks[1]["one_step"] == ((4, 2), 1, 0)


def test_narrow_model_skips_collectives(checks):
    assert checks[0]["narrow_step"] == ((4, 2), 0, 0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_detector_parity_model2(runs, scheme):
    got = _parity(runs[f"model2-{scheme}"], scheme)
    assert len(got) == 2
    for r in got:
        assert r["fused"] is False and r["steps"] == 4
        assert r["dispatches"] == 4 * r["steps"]
        assert r["collectives"] == r["gathers"] == {"model": 4, "data": 4}


@pytest.mark.parametrize("n_streams", (4, 5))
@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_detector_parity_data2_model2(runs, scheme, n_streams):
    got = _parity(runs[f"data2model2-{scheme}-s{n_streams}"], scheme)
    assert len(got) == 4
    for r in got:
        assert r["n_shards"] == r["model_shards"] == 2
        assert r["collectives"] == r["gathers"] == {"model": 4, "data": 4}


def test_adaptive_threshold_on_model_mesh(runs):
    entry = runs["adaptive"]
    got = _parity(entry, "REAL")
    plain = entry["plain"]
    assert got[0]["live"] == plain["live"]
    assert plain["live"] != [0.8]                # the threshold did adapt
    ref_live = [b[1][-1][5] for b in entry["ref"]]
    np.testing.assert_allclose([b[1][-1][5] for b in got[0]["batches"]],
                               ref_live, **_ref_tol("REAL"))


def test_grouped_model_mesh_parity(runs):
    got = _parity(runs["grouped-model"], "SINT")
    for r in got:
        # The 64-wide energy model is column-sharded; the detector is not.
        assert r["collectives"]["model"] > 0


@pytest.mark.parametrize("mode", ("per_group", "mega"))
@pytest.mark.parametrize("d", (2, 4))
@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_grouped_data_mesh_matches_unsharded_reference(runs, scheme, d, mode):
    got = _parity(runs[f"grouped-{scheme}-d{d}-{mode}"], scheme)
    assert len(got) == d
    for r in got:
        assert r["mega"] is (mode == "mega")
        assert r["dispatches"] == (1 if mode == "mega" else 4) * r["steps"]
        assert r["collectives"] == r["gathers"] == {"model": 0,
                                                    "data": r["steps"]}
        assert r["rows"] == [1] * 4        # 2 streams a group, padded


@pytest.mark.parametrize("mode", ("per_group", "mega", "mega-async"))
def test_grouped_adaptive_group_on_data_mesh(runs, mode):
    """The adaptive group's calibration state rides in the step's one data
    gather: the live threshold moves as the reference's."""
    entry = runs[f"grouped-adaptive-{mode}"]
    got = _parity(entry, "SINT")
    for r in got:
        assert r["live"][1] != 0.25
        assert r["collectives"]["data"] == r["steps"]
    assert got[0]["live"] == entry["plain"]["live"]
