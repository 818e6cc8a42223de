"""The port's continuous-batching engine and §6.3 multipart decode against
the JAX reference, on the CPU (mirrors ``tests/test_continuous.py``).

Reduced f32 configs, params from the JAX ``api.init`` bridged through numpy.
The engines are held to the reference's engines run on the same requests
in the same slots: greedy tokens equal, request for request (MoE capacity
couples the rows decoded together, so the schedule is the same on both
sides; inactive slots decode token 0 at their last position on both).  A
sampled row is held only to differ from the greedy one, as the port samples
with ``torch.multinomial``, not JAX's per-row keys.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models.api import get_model as jget_model
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import CyclicDecoder as JCyclicDecoder
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.continuous import _batch_axes as j_batch_axes
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.api import get_model
from repro_torch.serving import (ContinuousEngine, CycleStats, CyclicDecoder,
                                 Engine, Request, ServeStats)
from repro_torch.serving.continuous import _batch_axes

torch.set_num_threads(1)

CACHE = 64
_PAIRS = {}


def pair(arch, **kw):
    """(JAX api, JAX params, port api, port params) of the reduced f32
    config, built once per module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        jcfg = jget_config(arch).reduced().with_(dtype=jnp.float32, **kw)
        tcfg = get_config(arch).reduced().with_(dtype=torch.float32, **kw)
        japi = jget_model(jcfg)
        jp = japi.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _PAIRS[key] = (japi, jp, get_model(tcfg), tp)
    return _PAIRS[key]


def mixed(n, cls, temperature=0.0, vocab=None):
    """n requests with prompts of 3 + i tokens and 4 + 2i new tokens (the
    reference test's), or random prompts of the vocab when given."""
    rng = np.random.default_rng(3)
    return [cls(uid=i,
                prompt=(np.arange(3 + i, dtype=np.int32) if vocab is None
                        else rng.integers(0, vocab, 3 + 5 * i)
                        .astype(np.int32)),
                max_new_tokens=4 + 2 * i, temperature=temperature)
            for i in range(n)]


def by_uid(done):
    return {c.uid: np.asarray(c.tokens) for c in done}


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=str(uid))


@pytest.mark.parametrize("arch,n", [("qwen3_8b", 3), ("qwen3_8b", 5),
                                    ("granite_moe_1b_a400m", 5),
                                    ("mamba2_370m", 5)])
def test_greedy_tokens_match_reference(arch, n):
    """n requests through 2 slots (5: slots retire and are re-admitted):
    the same tokens as the JAX ContinuousEngine, request for request, the
    same number of steps, every request admitted once."""
    japi, jp, tapi, tp = pair(arch)
    vocab = tapi.cfg.vocab
    jeng = JContinuousEngine(japi, jp, batch_slots=2, cache_len=CACHE)
    want = by_uid(jeng.serve(mixed(n, JRequest, vocab=vocab)))
    eng = ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                           device="cpu")
    arena = {k: v.data_ptr() for k, v in eng.cache.items()}
    done = eng.serve(mixed(n, Request, vocab=vocab))
    assert_same(by_uid(done), want)
    assert isinstance(eng.last_stats, ServeStats)
    assert eng.last_stats.admitted == n
    assert eng.last_stats.steps == jeng.last_stats.steps
    assert eng.last_stats.steps < sum(4 + 2 * i for i in range(n))
    assert (eng._bucket is None) == (tapi.cfg.family != "dense")
    assert all(c.prefill_s > 0 and c.finished_s >= c.decode_s > 0
               for c in done)
    # the arena keeps its storage across serves, and a second serve gives
    # the same tokens (it starts from a zeroed arena, as the reference)
    assert_same(by_uid(eng.serve(mixed(n, Request, vocab=vocab))), want)
    assert {k: v.data_ptr() for k, v in eng.cache.items()} == arena


def test_dense_slots_match_single_request_wave_engine():
    """Per-request outputs equal the port's wave engine run one request at a
    time: slots never leak state into each other (the bucket pads are never
    attended to)."""
    _, _, tapi, tp = pair("qwen3_8b")
    reqs = mixed(5, Request)
    got = by_uid(ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                                  device="cpu").serve(reqs))
    single = Engine(tapi, tp, batch_slots=1, cache_len=CACHE, device="cpu")
    for r in reqs:
        want = single.serve([Request(uid=r.uid, prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens)])[0]
        np.testing.assert_array_equal(got[r.uid], want.tokens)


def test_eos_retires_slot_early():
    _, _, tapi, tp = pair("qwen3_8b")
    eng = ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                           device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    probe = eng.serve([Request(uid=0, prompt=prompt, max_new_tokens=6)])[0]
    eos = int(probe.tokens[2])
    first = int(np.flatnonzero(probe.tokens == eos)[0])
    got = eng.serve([Request(uid=1, prompt=prompt, max_new_tokens=6,
                             eos_token=eos)])[0]
    np.testing.assert_array_equal(got.tokens, probe.tokens[:first + 1])
    assert got.tokens[-1] == eos
    assert eng.last_stats.steps == first + 1


def test_slot_retires_at_the_cache_wall():
    """A request whose prompt and new tokens overrun the cache retires when
    its next write index reaches cache_len, with the reference's tokens; the
    other slot keeps decoding past it."""
    japi, jp, tapi, tp = pair("qwen3_8b")
    reqs = [(0, 12, 40), (1, 5, 10), (2, 3, 6)]
    want = by_uid(JContinuousEngine(japi, jp, batch_slots=2,
                                    cache_len=16).serve(
        [JRequest(uid=u, prompt=np.arange(n, dtype=np.int32) + 1,
                  max_new_tokens=m) for u, n, m in reqs]))
    got = by_uid(ContinuousEngine(tapi, tp, batch_slots=2, cache_len=16,
                                  device="cpu").serve(
        [Request(uid=u, prompt=np.arange(n, dtype=np.int32) + 1,
                 max_new_tokens=m) for u, n, m in reqs]))
    assert_same(got, want)
    assert len(got[0]) == 16 - 12 + 1


def test_per_slot_temperatures():
    """A greedy and a sampled request share one step: the greedy slot still
    gives the deterministic tokens, the hot one others, and a second serve
    draws fresh samples."""
    _, _, tapi, tp = pair("qwen3_8b")
    eng = ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                           device="cpu")
    prompt = np.arange(5, dtype=np.int32)

    def reqs():
        return [Request(uid=0, prompt=prompt, max_new_tokens=8),
                Request(uid=1, prompt=prompt, max_new_tokens=8,
                        temperature=5.0)]
    got = by_uid(eng.serve(reqs()))
    want = Engine(tapi, tp, batch_slots=1, cache_len=CACHE,
                  device="cpu").serve([Request(uid=0, prompt=prompt,
                                               max_new_tokens=8)])[0].tokens
    np.testing.assert_array_equal(got[0], want)
    assert not np.array_equal(got[1], got[0])
    again = by_uid(eng.serve(reqs()))
    np.testing.assert_array_equal(again[0], want)
    assert not np.array_equal(again[1], got[1])


@pytest.mark.parametrize("arch", ("qwen3_8b", "granite_moe_1b_a400m",
                                  "mamba2_370m"))
def test_cyclic_segments_equal_plain_continuous(arch):
    """§6.3 segments compose with continuous slots: the segment-sliced step
    gives the plain step's tokens, and the reference's."""
    japi, jp, tapi, tp = pair(arch)
    reqs = mixed(3, Request, vocab=tapi.cfg.vocab)
    plain = by_uid(ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                                    device="cpu").serve(reqs))
    eng = ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                           cyclic_segments=2, device="cpu")
    assert eng._cyclic.bounds == [(0, 1), (1, 2)]
    assert_same(by_uid(eng.serve(reqs)), plain)
    want = by_uid(JContinuousEngine(japi, jp, batch_slots=2, cache_len=CACHE,
                                    cyclic_segments=2).serve(
        mixed(3, JRequest, vocab=tapi.cfg.vocab)))
    assert_same(plain, want)


@pytest.mark.parametrize("arch", ("qwen3_8b", "granite_moe_1b_a400m",
                                  "mamba2_370m"))
def test_cyclic_decode_tokens_match_reference(arch):
    """CyclicDecoder.decode_tokens from a prefilled cache: the reference's
    tokens, one cycle time per segment per token, the cache updated in
    place and within 1e-5 of the reference's (of the largest value)."""
    japi, jp, tapi, tp = pair(arch)
    prompt = np.random.default_rng(4).integers(0, tapi.cfg.vocab, (1, 12))
    jcache, jlogits = japi.prefill(jp, {"tokens": jnp.asarray(prompt)},
                                   CACHE)
    jfirst = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
    jtoks, jcache, _ = JCyclicDecoder(
        japi.cfg, jp, n_segments=2, batch=1,
        cache_len=CACHE).decode_tokens(jcache, jfirst, 12, 6)
    cache, logits = tapi.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                                 CACHE)
    first = torch.argmax(logits[:, -1], -1)
    assert int(first[0]) == int(jfirst[0])
    ticks = []
    cd = CyclicDecoder(tapi.cfg, tp, n_segments=2, batch=1, cache_len=CACHE,
                       device="cpu")
    toks, out, stats = cd.decode_tokens(cache, first, 12, 6,
                                        control_task=lambda: ticks.append(1))
    assert toks == jtoks
    assert out is cache
    assert isinstance(stats, CycleStats) and stats.cycles_per_token == 2
    assert len(stats.cycle_times_s) == len(ticks) == 12
    for k in jcache:
        want = np.asarray(jcache[k], np.float32)
        err = np.abs(cache[k].float().numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), k


def test_cyclic_bounds_follow_linspace():
    _, _, tapi, tp = pair("qwen3_8b")
    cfg = tapi.cfg.with_(n_layers=7)
    for n, want in ((3, [(0, 2), (2, 4), (4, 7)]), (1, [(0, 7)]),
                    (9, [(i, i + 1) for i in range(7)])):
        assert CyclicDecoder(cfg, tp, n_segments=n, batch=1, cache_len=8,
                             device="cpu").bounds == want
        assert JCyclicDecoder(jget_config("qwen3_8b").reduced().with_(
            n_layers=7), None, n_segments=n, batch=1,
            cache_len=8).bounds == want


def test_kv_quant_slots_complete():
    """The int8 KV cache (§6.1) through the per-slot decode path."""
    _, _, tapi, tp = pair("qwen3_8b", kv_quant=True)
    eng = ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                           device="cpu")
    assert sorted(eng.cache) == ["k", "k_scale", "v", "v_scale"]
    done = eng.serve(mixed(3, Request))
    assert sorted(c.uid for c in done) == [0, 1, 2]
    assert all(len(c.tokens) == 4 + 2 * c.uid for c in done)


def test_unsupported_combinations_rejected():
    _, _, tapi, tp = pair("qwen3_8b")
    for family in ("vlm", "audio"):
        api = dataclasses.replace(tapi, cfg=tapi.cfg.with_(family=family))
        with pytest.raises(NotImplementedError, match="extras"):
            ContinuousEngine(api, None, batch_slots=2, cache_len=CACHE)
    kvq = get_model(tapi.cfg.with_(kv_quant=True))
    with pytest.raises(NotImplementedError, match="kv_quant"):
        ContinuousEngine(kvq, None, batch_slots=2, cache_len=CACHE,
                         cyclic_segments=2)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        CyclicDecoder(kvq.cfg, None, n_segments=2, batch=1, cache_len=8,
                      device="cpu")
    for family in ("hybrid", "audio"):
        with pytest.raises(NotImplementedError, match=family):
            CyclicDecoder(tapi.cfg.with_(family=family), None, n_segments=2,
                          batch=1, cache_len=8, device="cpu")
    eng = ContinuousEngine(tapi, tp, batch_slots=1, cache_len=8,
                           device="cpu")
    with pytest.raises(ValueError, match="must fit the cache"):
        eng.serve([Request(uid=0, prompt=np.zeros(8, np.int32),
                           max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.serve([Request(uid=0, prompt=np.zeros(3, np.int32),
                           max_new_tokens=0)])


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen3_8b", False), ("qwen3_8b", True),
    ("granite_moe_1b_a400m", False), ("mamba2_370m", False)])
def test_batch_axes_match_reference(arch, kv_quant):
    jcfg = jget_config(arch).reduced().with_(kv_quant=kv_quant)
    tcfg = get_config(arch).reduced().with_(kv_quant=kv_quant)
    want = j_batch_axes(jget_model(jcfg), CACHE)
    assert _batch_axes(get_model(tcfg), CACHE) == want
    assert want == [1] * len(want)


@pytest.mark.parametrize("argv", [
    ["--engine", "wave", "--quant", "SINT"],
    ["--engine", "continuous", "--cyclic", "2"],
    ["--cyclic", "2"],
], ids=("wave-sint", "continuous-cyclic", "cyclic-decoder"))
def test_launch_serve_on_cpu(argv, capsys):
    """``python -m repro_torch.launch.serve`` end to end on the CPU."""
    launch_serve.main(["--arch", "qwen3_8b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "6", "--max-new",
                       "4", "--batch-slots", "2", "--cache-len", "32"]
                      + argv)
    out = capsys.readouterr().out
    if argv == ["--cyclic", "2"]:
        assert "cyclic decode: 4 tokens" in out and "2 cycles/token" in out
    else:
        assert sum(line.startswith("req ") for line in out.splitlines()) == 3
