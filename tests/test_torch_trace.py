"""The port's tracer (``repro_torch.trace``) and the engines and models under
it, on the CPU at the reduced sizes, and on the card the clock it shares
with torch.profiler.

Off, a served call records nothing and creates no CUDA event.  On, the
spans nest as the engines call the model (``engine.serve`` > ``engine.admit``
/ ``engine.step`` / ``engine.prefill`` > ``model.forward`` > ``model.moe``,
``model.linear``), one per admission, step, wave and model call, and the
counters add up to the slots stepped and the tokens made.  Served tokens,
``ServeStats`` and every ``Completion`` field but its timings are the same
with the tracer on and off.  ``model.norm_codes`` counts the SINT Mamba
norms that write their projection's codes in one launch: two a layer a
prefill on the card, none on the CPU or in a decode step.  The card tests
(marker ``cuda``, skip without CUDA) run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_trace.py``.
"""

import collections
import time

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs.base import get_config
from repro_torch.models.api import get_model
from repro_torch.serving import ContinuousEngine, Engine, Request

torch.set_num_threads(1)

SLOTS, CACHE = 2, 32
_APIS = {}


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def model(arch):
    """(api, params) of the reduced f32 SINT config, built once."""
    if arch not in _APIS:
        cfg = get_config(arch).reduced().with_(dtype=torch.float32,
                                               quant="SINT")
        api = get_model(cfg)
        _APIS[arch] = (api, api.init(torch.Generator().manual_seed(0),
                                     device="cpu"))
    return _APIS[arch]


def requests(vocab, n=5):
    """n requests, prompts of 2 + 3i tokens (each prefills), 2 + i new."""
    rng = np.random.default_rng(7)
    return [Request(uid=100 + i, prompt=rng.integers(0, vocab, 2 + 3 * i),
                    max_new_tokens=2 + i) for i in range(n)]


def engine(arch, kind):
    api, params = model(arch)
    cls = ContinuousEngine if kind == "continuous" else Engine
    return cls(api, params, batch_slots=SLOTS, cache_len=CACHE,
               device="cpu")


def traced(eng, reqs):
    trace.enable()
    done = eng.serve(reqs)
    doc = trace.drain()
    trace.disable()
    return done, doc


def named(doc, name):
    return [s for s in doc["spans"] if s["name"] == name]


def ancestors(doc, s):
    by_id = {x["id"]: x for x in doc["spans"]}
    out = []
    while s["parent"] is not None:
        s = by_id[s["parent"]]
        out.append(s["name"])
    return out


# -- the tracer alone --------------------------------------------------------


class FakeEvent:
    """A stand-in for ``torch.cuda.Event``: records its order of record."""
    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        assert stream == "stream"
        FakeEvent.clock += 1
        self.at = FakeEvent.clock

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made = FakeEvent.clock = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    yield syncs
    trace.drain()


def test_off_is_one_shared_no_op_and_creates_no_event(fake_cuda):
    cuda = torch.device("cuda")
    a = trace.span("engine.step", device=cuda)
    b = trace.span("model.linear", uid=3, device=cuda)
    assert a is b
    with a:
        trace.count("engine.slot_steps", 16)
    doc = trace.drain()
    assert doc["spans"] == [] and doc["counters"] == {}
    assert FakeEvent.made == 0 and fake_cuda == []


def test_spans_nest_with_parents_uids_and_host_times():
    trace.enable()
    with trace.span("outer"):
        with trace.span("a", uid=7):
            with trace.span("leaf"):
                pass
        with trace.span("b"):
            pass
    trace.count("c", 2)
    trace.count("c", np.int64(3))
    doc = trace.drain()
    by = {s["name"]: s for s in doc["spans"]}
    assert by["outer"]["parent"] is None
    assert by["a"]["parent"] == by["b"]["parent"] == by["outer"]["id"]
    assert by["leaf"]["parent"] == by["a"]["id"]
    assert by["a"]["uid"] == 7 and by["b"]["uid"] is None
    assert all(s["device_ms"] is None for s in doc["spans"])
    o = by["outer"]
    for s in doc["spans"]:
        assert o["start_ns"] <= s["start_ns"] <= s["end_ns"] <= o["end_ns"]
    assert doc["counters"] == {"c": 5}
    assert trace.drain()["spans"] == []


def test_device_spans_resolve_events_at_drain_and_reuse_them(fake_cuda):
    trace.enable()
    with trace.span("step", device=torch.device("cuda", 0)):
        with trace.span("linear", device=torch.empty(0, device="meta")):
            pass
        with trace.span("cuda_tensor", device=type(
                "T", (), {"device": torch.device("cuda")})()):
            pass
    assert fake_cuda == []          # nothing waits before drain
    doc = trace.drain()
    assert len(fake_cuda) == 1
    by = {s["name"]: s for s in doc["spans"]}
    assert by["linear"]["device_ms"] is None          # not a CUDA tensor
    assert by["cuda_tensor"]["device_ms"] == 1.0
    assert by["step"]["device_ms"] == 3.0             # around the inner pair
    assert FakeEvent.made == 4      # a pair a device span, made as it opens
    cuda = torch.device("cuda")
    trace.enable(device_spans={"engine.prefill": None,
                               "model.linear": "engine.prefill"})
    with trace.span("engine.step", device=cuda):
        with trace.span("model.linear", uid=1, device=cuda):
            pass
    with trace.span("engine.prefill", device=cuda):
        with trace.span("model.forward", device=cuda):
            with trace.span("model.linear", uid=2, device=cuda):
                pass
    got = {(s["name"], s["uid"]): s["device_ms"]
           for s in trace.drain()["spans"]}
    assert got == {("engine.step", None): None, ("model.linear", 1): None,
                   ("engine.prefill", None): 3.0,
                   ("model.forward", None): None, ("model.linear", 2): 1.0}


def wall_ns(anchors, perf_ns):
    """A ``perf_counter_ns`` reading on the wall clock, interpolated
    between a drain's two anchors (as the benchmark's readers map spans)."""
    (p0, w0), (p1, w1) = anchors
    rate = (w1 - w0) / (p1 - p0) if p1 != p0 else 1.0
    return w0 + (perf_ns - p0) * rate


def test_anchors_interpolate_between_enable_and_drain():
    trace.enable()
    t_perf = time.perf_counter_ns()
    t_wall = time.time_ns()
    first = trace.drain()
    (p0, w0), (p1, w1) = first["anchors"]
    assert p0 <= t_perf <= p1 and w0 <= t_wall <= w1
    assert abs(wall_ns(first["anchors"], t_perf) - t_wall) < 5e6
    # (a float near 1.8e18 ns holds the time to 256 ns)
    assert wall_ns(first["anchors"], p0) == pytest.approx(w0, abs=1e3)
    assert wall_ns(first["anchors"], p1) == pytest.approx(w1, abs=1e3)
    assert wall_ns([(0, 100), (10, 120)], 5) == 110
    # the next drain starts from this one's anchor
    assert trace.drain()["anchors"][0] == first["anchors"][1]


# -- the engines under it ------------------------------------------------------


@pytest.mark.parametrize("arch", ("jamba_1_5_large_398b",
                                  "granite_moe_1b_a400m"))
def test_continuous_spans_and_counters(arch):
    eng = engine(arch, "continuous")
    reqs = requests(eng.api.cfg.vocab)
    done, doc = traced(eng, reqs)
    stats = eng.last_stats
    serve = named(doc, "engine.serve")
    assert len(serve) == 1 and serve[0]["parent"] is None
    steps, admits = named(doc, "engine.step"), named(doc, "engine.admit")
    assert len(steps) == stats.steps
    assert len(admits) == stats.admitted == len(reqs)
    assert sorted(s["uid"] for s in admits) == [r.uid for r in reqs]
    for s in steps + admits:
        assert s["parent"] == serve[0]["id"]
    forwards = named(doc, "model.forward")
    # every prompt here has 2+ tokens: one prefill an admission, one
    # decode_multi a step
    assert len(forwards) == stats.admitted + stats.steps
    parents = collections.Counter(ancestors(doc, f)[0] for f in forwards)
    assert parents == {"engine.admit": stats.admitted,
                       "engine.step": stats.steps}
    moes = named(doc, "model.moe")
    assert moes and len(moes) % len(forwards) == 0
    for m in moes:
        assert ancestors(doc, m)[0] == "model.forward"
    for lin in named(doc, "model.linear"):
        assert ancestors(doc, lin)[0] == "model.forward"
    assert doc["counters"] == {
        "engine.slot_steps": stats.steps * SLOTS,
        "engine.active_slot_steps": sum(len(c.tokens) for c in done)}
    assert all(s["device_ms"] is None for s in doc["spans"])


def test_wave_spans_one_prefill_a_wave():
    eng = engine("mamba2_370m", "wave")
    reqs = requests(eng.api.cfg.vocab)
    done, doc = traced(eng, reqs)
    waves = [reqs[i:i + SLOTS] for i in range(0, len(reqs), SLOTS)]
    serve = named(doc, "engine.serve")
    prefills = named(doc, "engine.prefill")
    assert len(serve) == 1 and len(prefills) == len(waves)
    assert all(p["parent"] == serve[0]["id"] for p in prefills)
    forwards = named(doc, "model.forward")
    # a prefill and max_new - 1 decode steps a wave
    assert len(forwards) == sum(max(r.max_new_tokens for r in w)
                                for w in waves)
    inside = [f for f in forwards if "engine.prefill" in ancestors(doc, f)]
    assert len(inside) == len(waves)
    lin = named(doc, "model.linear")
    assert lin and all(ancestors(doc, x)[0] == "model.forward" for x in lin)
    # the prefill span covers the same interval as Completion.prefill_s
    by_wave = sorted({c.prefill_s for c in done})
    spans_s = sorted((p["end_ns"] - p["start_ns"]) / 1e9 for p in prefills)
    for got, want in zip(spans_s, by_wave):
        assert want <= got <= want + 5e-3
    assert doc["counters"] == {}


def test_off_serve_records_nothing(fake_cuda):
    eng = engine("jamba_1_5_large_398b", "continuous")
    eng.serve(requests(eng.api.cfg.vocab))
    doc = trace.drain()
    assert doc["spans"] == [] and doc["counters"] == {}
    assert FakeEvent.made == 0 and fake_cuda == []


@pytest.mark.parametrize("arch,kind", [
    ("jamba_1_5_large_398b", "continuous"),
    ("granite_moe_1b_a400m", "continuous"),
    ("qwen3_8b", "continuous"),
    ("mamba2_370m", "wave"),
    ("jamba_1_5_large_398b", "wave")])
def test_tokens_and_stats_equal_with_tracer_on_and_off(arch, kind):
    eng = engine(arch, kind)
    reqs = requests(eng.api.cfg.vocab)
    off = eng.serve(reqs)
    off_stats = getattr(eng, "last_stats", None)
    on, doc = traced(eng, reqs)
    assert doc["spans"]
    assert [c.uid for c in on] == [c.uid for c in off]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.uid))
    if off_stats is not None:
        on_stats = eng.last_stats
        assert (on_stats.steps, on_stats.admitted) == \
            (off_stats.steps, off_stats.admitted)


def prefill_and_decode_counters(api, params, device):
    """The counters of one prefill of two 9-token prompts, then of one
    decode step of two rows on a zero arena."""
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, api.cfg.vocab, (2, 9))).to(device)
    trace.enable()
    api.prefill(params, {"tokens": tokens}, 16)
    prefill = trace.drain()["counters"]
    api.decode(params, api.init_cache(2, 16, device=device),
               {"tokens": tokens[:, :1]}, 9)
    decode = trace.drain()["counters"]
    trace.disable()
    return prefill, decode


@pytest.mark.parametrize("arch", ("mamba2_370m", "jamba_1_5_large_398b"))
def test_cpu_sint_mamba_counts_no_norm_codes(arch):
    """On the CPU the SINT Mamba layers norm and quantize with the eager
    ops: a prefill and a decode step count no ``model.norm_codes``."""
    api, params = model(arch)
    assert prefill_and_decode_counters(api, params, "cpu") == ({}, {})


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("mamba2_370m", "jamba_1_5_large_398b"))
def test_card_sint_prefill_counts_norm_codes(arch):
    """On the card a SINT prefill counts two ``model.norm_codes`` a Mamba
    layer (its pre-norm and its gated norm) and a decode step none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the norm_codes kernel")
    cfg = get_config(arch).reduced().with_(quant="SINT")
    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    n_mamba = cfg.n_layers - cfg.n_layers // max(cfg.attn_period, 1) \
        if cfg.family == "hybrid" else cfg.n_layers
    with torch.no_grad():
        counters = prefill_and_decode_counters(api, params, "cuda")
    assert counters == ({"model.norm_codes": 2 * n_mamba}, {})


@pytest.mark.cuda
def test_card_span_shares_the_profilers_clock():
    """Two device spans, each around a ~0.5 ms spin kernel
    (``torch.cuda._sleep``), in one device-only torch.profiler session; the
    drain's anchors map each kernel's record onto the span's host clock.

    - On an idle stream (the regime of an admission, or of a host-bound
      decode step): the kernel's record lies inside the span.  The span's
      first event completes as soon as the stream reaches it, before the
      kernel has been launched, so the span's event time is at least the
      record's length and exceeds it by at most the time from the span's
      opening to the kernel's start (the launch), plus the clocks' error.
    - On a busy stream (a longer spin ahead, so that the first event waits
      behind it, as inside a card-bound step): the record lies inside the
      span, and the span's event time is within 10% of its length.

    As in ``perfbench/lib/profiling.py``, an empty session goes first and
    the session opens with short spins, since a session can lose its first
    device records."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events and CUPTI records")
    from torch.profiler import ProfilerActivity, profile
    torch.zeros(1, device="cuda")
    cuda_dev = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        trace.enable()
        with trace.span("idle_stream", device=cuda_dev):
            torch.cuda._sleep(10 ** 6)
            torch.cuda.synchronize()
        torch.cuda._sleep(2 * 10 ** 6)
        with trace.span("busy_stream", device=cuda_dev):
            torch.cuda._sleep(10 ** 6)
            torch.cuda.synchronize()
        doc = trace.drain()
        trace.disable()
    cuda = torch.autograd.DeviceType.CUDA
    spins = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and "spin_kernel" in e.name()
                   and not e.is_user_annotation())
    assert len(spins) >= 4, spins
    lead_in, idle_k, ahead, busy_k = spins[-4:]
    # the spans' kernels follow the lead-in's short spins, in order
    assert idle_k[1] - idle_k[0] > 10 * (lead_in[1] - lead_in[0])
    assert ahead[1] - ahead[0] > busy_k[1] - busy_k[0]
    by = {s["name"]: s for s in doc["spans"]}
    clock_err_ms = 0.05
    for name, (k0, k1) in (("idle_stream", idle_k), ("busy_stream", busy_k)):
        s = by[name]
        lo = wall_ns(doc["anchors"], s["start_ns"])
        hi = wall_ns(doc["anchors"], s["end_ns"])
        length = (k1 - k0) / 1e6
        print(f"{name}: span {lo:.0f}..{hi:.0f} ns, kernel {k0}..{k1} ns: "
              f"{k0 - lo:.0f} ns after the span opens, {hi - k1:.0f} ns "
              f"before it closes; events {s['device_ms']:.4f} ms, record "
              f"{length:.4f} ms")
        assert lo <= k0 < k1 <= hi
        if name == "idle_stream":
            assert s["device_ms"] >= length
            assert s["device_ms"] <= (k1 - lo) / 1e6 + clock_err_ms
        else:
            assert s["device_ms"] == pytest.approx(length, rel=0.1)
