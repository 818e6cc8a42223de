"""The port's training substrate against the JAX reference, on the CPU:
AdamW and SGD, the learning-rate schedules, the synthetic LM stream and its
binary shards, and the npz checkpoint format.

The first three classes are the port's twins of ``tests/test_substrate.py``
(the same checks on ``repro_torch``).  The rest hold the port to the
reference on the same inputs: one AdamW update in f32 within 1e-6 relative
(the same f32 operations in the same order; XLA and PyTorch may each round
a ``pow`` or ``sqrt`` an ulp apart); a bf16 leaf within one bf16 ulp of the
update and its f32 moments within 1e-5 (the clipped gradient must be
promoted to f32 before the moments, as JAX promotes it); the schedules
within 1e-7; ``SyntheticLM`` batches byte-equal; checkpoints written by
either package restored by the other bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.checkpoint import latest_step as jlatest_step
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import read_shard as jread_shard
from repro_torch import optim
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.data import (DataConfig, ShardedDataset, SyntheticLM,
                              read_shard, write_shard)

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits16(x):
    """The 16-bit pattern of a bf16 tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def meta_like(tree):
    return {k: meta_like(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


# -- twins of tests/test_substrate.py ---------------------------------------


class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        target = torch.tensor([1.0, 2.0])
        init, update = optim.adamw(0.1, weight_decay=0.0)
        state = init(params)
        for _ in range(300):
            grads = {"w": 2 * (params["w"] - target)}
            upd, state = update(grads, state, params)
            params = optim.apply_updates(params, upd)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                                   atol=1e-2)

    def test_integer_leaves_untouched(self):
        params = {"qw": torch.ones((2, 2), dtype=torch.int8),
                  "w": torch.ones((2,))}
        init, update = optim.adamw(0.1)
        state = init(params)
        assert state.mu["qw"].shape == () and state.nu["qw"].shape == ()
        grads = {"qw": torch.zeros((2, 2), dtype=torch.int8),
                 "w": torch.ones((2,))}
        upd, state = update(grads, state, params)
        assert int(upd["qw"].abs().max()) == 0
        assert float(upd["w"].abs().max()) > 0
        optim.apply_updates(params, upd)
        assert torch.equal(params["qw"], torch.ones((2, 2),
                                                    dtype=torch.int8))

    def test_grad_clip(self):
        params = {"w": torch.zeros((3,))}
        init, update = optim.adamw(1.0, grad_clip=1.0, weight_decay=0.0)
        state = init(params)
        upd, _ = update({"w": torch.full((3,), 1e6)}, state, params)
        assert torch.isfinite(upd["w"]).all()

    def test_schedules(self):
        fn = optim.linear_warmup_cosine(1.0, warmup=10, steps=110)
        assert float(fn(torch.tensor(0, dtype=torch.int32))) == 0.0
        assert abs(float(fn(torch.tensor(10, dtype=torch.int32))) - 1.0) \
            < 1e-6
        assert float(fn(torch.tensor(110, dtype=torch.int32))) < 0.2


class TestData:
    def test_deterministic(self):
        cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=7)
        a = next(SyntheticLM(cfg).batches())
        b = next(SyntheticLM(cfg).batches())
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = DataConfig(vocab=50, seq_len=8, global_batch=2)
        batch = next(SyntheticLM(cfg).batches())
        assert batch["tokens"].shape == (2, 8)
        assert batch["labels"].shape == (2, 8)
        np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                      batch["labels"][:, :-1])

    def test_markov_structure_learnable(self):
        """The successor structure exists: P(label == succ[token]) >>
        1 / vocab."""
        cfg = DataConfig(vocab=64, seq_len=128, global_batch=8, seed=3)
        src = SyntheticLM(cfg)
        batch = next(src.batches())
        hit = (batch["labels"] == src._succ[batch["tokens"]]).mean()
        assert hit > 0.5

    def test_shard_roundtrip(self, tmp_path):
        tokens = np.random.default_rng(0).integers(0, 99, (10, 17)) \
            .astype(np.int32)
        path = str(tmp_path / "shard0.bin")
        write_shard(path, tokens)
        np.testing.assert_array_equal(read_shard(path), tokens)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
        save(str(tmp_path), 5, tree)
        assert latest_step(str(tmp_path)) == 5
        back = restore(str(tmp_path), meta_like(tree), device="cpu")
        assert torch.equal(back["a"], tree["a"])
        assert back["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(back["b"]["c"], tree["b"]["c"])

    def test_shape_mismatch_raises(self, tmp_path):
        save(str(tmp_path), 1, {"a": torch.zeros((3,))})
        with pytest.raises(ValueError):
            restore(str(tmp_path), {"a": torch.empty((4,), device="meta")},
                    device="cpu")
        with pytest.raises(KeyError):
            restore(str(tmp_path), {"b": torch.empty((3,), device="meta")},
                    device="cpu")

    def test_multiple_steps_latest_wins(self, tmp_path):
        save(str(tmp_path), 1, {"a": torch.zeros((2,))})
        save(str(tmp_path), 2, {"a": torch.ones((2,))})
        back = restore(str(tmp_path), {"a": torch.empty((2,), device="meta")},
                       device="cpu")
        assert torch.equal(back["a"], torch.ones(2))
        assert torch.equal(restore(str(tmp_path), {"a": torch.zeros(2)},
                                   step=1)["a"], torch.zeros(2))


# -- the port against the reference -----------------------------------------


def tree_pair(seed, scale=1.0, int_leaf=True):
    """(numpy params, numpy grads): a nested tree with an int8 leaf."""
    rng = np.random.default_rng(seed)

    def f32(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    params = {"emb": f32(16, 8), "blocks": {"w": f32(2, 8, 8),
                                            "g": f32(8)},
              "b": f32(8)}
    grads = {"emb": f32(16, 8, s=scale),
             "blocks": {"w": f32(2, 8, 8, s=scale), "g": f32(8, s=scale)},
             "b": f32(8, s=scale)}
    if int_leaf:
        params["qw"] = rng.integers(-127, 128, (8, 4)).astype(np.int8)
        grads["qw"] = np.zeros((8, 4), np.int8)
    return params, grads


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return {k: to_port(v) if isinstance(v, dict) else t(v.copy())
            for k, v in tree.items()}


def flat_pairs(jtree, ttree, path=""):
    for k, v in ttree.items():
        if isinstance(v, dict):
            yield from flat_pairs(jtree[k], v, f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(jtree[k]), v


@pytest.mark.parametrize("clip_active", (False, True))
def test_adamw_update_matches_reference(clip_active):
    """Three AdamW steps from bridged params and gradients (the clip on or
    off): updates, params and both moments within 1e-6 relative; the
    integer leaf's update exactly 0."""
    lr_kw = dict(lr=1e-2, warmup=2, steps=10)
    jinit, jupdate = joptim.adamw(joptim.linear_warmup_cosine(**lr_kw))
    init, update = optim.adamw(optim.linear_warmup_cosine(**lr_kw))
    p_np, _ = tree_pair(0)
    jp, tp = to_jax(p_np), to_port(p_np)
    jstate, tstate = jinit(jp), init(tp)
    for step in range(3):
        _, g_np = tree_pair(step + 1, scale=10.0 if clip_active else 0.01)
        assert (float(joptim.global_norm(to_jax(g_np))) > 1.0) == clip_active
        jupd, jstate = jupdate(to_jax(g_np), jstate, jp)
        jp = joptim.apply_updates(jp, jupd)
        tupd, tstate = update(to_port(g_np), tstate, tp)
        tp = optim.apply_updates(tp, tupd)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for name, jt, tt in [*flat_pairs(jupd, tupd),
                             *flat_pairs(jp, tp),
                             *flat_pairs(jstate.mu, tstate.mu),
                             *flat_pairs(jstate.nu, tstate.nu)]:
            np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-6,
                                       atol=1e-6 * np.abs(jt).max(),
                                       err_msg=name)
        assert not tupd["qw"].any() and torch.equal(tp["qw"],
                                                    t(p_np["qw"]))


def test_adamw_bf16_leaf_promotes_the_clipped_gradient():
    """A bf16 parameter and gradient with the clip active: JAX promotes the
    clipped bf16 gradient to f32 (bf16 x f32 0-d), so the f32 moments carry
    no bf16 rounding of it: within 1e-5 relative (the global norm's f32 sum
    over 2,048 squares is added up in another order, ~1e-6), where the
    gradient scaled in bf16 parts by ~1e-3.  The bf16 update and param sit
    within one bf16 ulp of the reference's."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((64, 32)) * 0.05).astype(np.float32)
    g = (rng.standard_normal((64, 32)) * 3.0).astype(np.float32)
    jp = {"w": jnp.asarray(w).astype(jnp.bfloat16)}
    jg = {"w": jnp.asarray(g).astype(jnp.bfloat16)}
    tp = {"w": t(w).to(torch.bfloat16)}
    tg = {"w": t(g).to(torch.bfloat16)}
    assert np.array_equal(bits16(jp["w"]), bits16(tp["w"]))
    assert float(joptim.global_norm(jg)) > 1.0
    jinit, jupdate = joptim.adamw(1e-3)
    init, update = optim.adamw(1e-3)
    jupd, jstate = jupdate(jg, jinit(jp), jp)
    tupd, tstate = update(tg, init(tp), tp)
    for jm, tm in ((jstate.mu["w"], tstate.mu["w"]),
                   (jstate.nu["w"], tstate.nu["w"])):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=0)
    scale = torch.clamp(1.0 / (optim.global_norm(tg) + 1e-9), max=1.0)
    assert (tg["w"] * scale).dtype == torch.bfloat16
    in_bf16 = (1 - 0.9) * (tg["w"] * scale).to(torch.float32)
    assert float(((in_bf16 - tstate.mu["w"]) / tstate.mu["w"]).abs()
                 .max()) > 1e-4
    assert tupd["w"].dtype == torch.bfloat16
    jnew = joptim.apply_updates(jp, jupd)
    tnew = optim.apply_updates(tp, tupd)
    for ja, ta in ((jupd["w"], tupd["w"]), (jnew["w"], tnew["w"])):
        assert np.abs(bits16(ja).astype(np.int32)
                      - bits16(ta).astype(np.int32)).max() <= 1


def test_sgd_matches_reference():
    jinit, jupdate = joptim.sgd(0.1, momentum=0.9)
    init, update = optim.sgd(0.1, momentum=0.9)
    p_np, _ = tree_pair(0)
    jp, tp = to_jax(p_np), to_port(p_np)
    jstate, tstate = jinit(jp), init(tp)
    for step in range(3):
        _, g_np = tree_pair(step + 1)
        jupd, jstate = jupdate(to_jax(g_np), jstate, jp)
        jp = joptim.apply_updates(jp, jupd)
        tupd, tstate = update(to_port(g_np), tstate, tp)
        tp = optim.apply_updates(tp, tupd)
    for name, jt, tt in [*flat_pairs(jp, tp),
                         *flat_pairs(jstate.mu, tstate.mu)]:
        np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_global_norm_matches_reference():
    _, g_np = tree_pair(3, scale=2.0)
    np.testing.assert_allclose(float(optim.global_norm(to_port(g_np))),
                               float(joptim.global_norm(to_jax(g_np))),
                               rtol=1e-6)


@pytest.mark.parametrize("name,args,steps", [
    ("constant", (3e-4,), (0, 5, 100)),
    ("cosine_decay", (6e-4, 100), (0, 50, 100, 150)),
    ("linear_warmup_cosine", (1.0, 10, 110), (0, 3, 10, 60, 110)),
    ("linear_warmup_cosine", (6e-4, 50, 300), (0, 50, 300)),
])
def test_schedules_match_reference(name, args, steps):
    jfn, tfn = getattr(joptim, name)(*args), getattr(optim, name)(*args)
    for s in steps:
        want = float(jfn(jnp.int32(s)))
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, (name, s, float(got), want)


def test_synthetic_lm_batches_byte_equal():
    for kw in (dict(vocab=1000, seq_len=64, global_batch=4, seed=0),
               dict(vocab=151936, seq_len=32, global_batch=2, seed=3)):
        ours = SyntheticLM(DataConfig(**kw)).batches()
        theirs = JSyntheticLM(JDataConfig(**kw)).batches()
        for _ in range(3):
            a, b = next(ours), next(theirs)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].tobytes() == b[k].tobytes()


def test_shards_cross_packages(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"shard{i}.bin")
        write_shard(path, rng.integers(0, 500, (6, 9)).astype(np.int32))
        paths.append(path)
        np.testing.assert_array_equal(read_shard(path), jread_shard(path))
    ours = ShardedDataset(paths, global_batch=4).batches(start_step=1)
    theirs = JShardedDataset(paths, global_batch=4).batches(start_step=1)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["labels"].tobytes() == b["labels"].tobytes()
    with pytest.raises(ValueError):
        ShardedDataset([], global_batch=4)


def mixed_tree(seed):
    """(numpy f32 arrays of a bf16, an int8 and an f32 leaf)."""
    rng = np.random.default_rng(seed)
    return {"params": {"emb": rng.standard_normal((5, 3)).astype(np.float32),
                       "blocks": {"qw": rng.integers(-127, 128, (2, 4, 3))
                                  .astype(np.int8)}},
            "g": rng.standard_normal((7,)).astype(np.float32)}


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    src = mixed_tree(0)
    tree = {"params": {"emb": t(src["params"]["emb"]).to(torch.bfloat16),
                       "blocks": {"qw": t(src["params"]["blocks"]["qw"])}},
            "g": t(src["g"])}
    save(str(tmp_path), 3, tree)
    assert jlatest_step(str(tmp_path)) == 3
    like = {"params": {"emb": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16),
                       "blocks": {"qw": jax.ShapeDtypeStruct((2, 4, 3),
                                                             jnp.int8)}},
            "g": jax.ShapeDtypeStruct((7,), jnp.float32)}
    back = jrestore(str(tmp_path), like)
    assert back["params"]["emb"].dtype == jnp.bfloat16
    assert np.array_equal(bits16(back["params"]["emb"]),
                          bits16(tree["params"]["emb"]))
    assert np.array_equal(np.asarray(back["params"]["blocks"]["qw"]),
                          src["params"]["blocks"]["qw"])
    assert np.asarray(back["g"]).tobytes() == src["g"].tobytes()


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    src = mixed_tree(1)
    jtree = {"params": {"emb": jnp.asarray(src["params"]["emb"])
                        .astype(jnp.bfloat16),
                        "blocks": {"qw": jnp.asarray(
                            src["params"]["blocks"]["qw"])}},
             "g": jnp.asarray(src["g"])}
    jsave(str(tmp_path), 4, jtree)
    assert latest_step(str(tmp_path)) == 4
    like = {"params": {"emb": torch.empty((5, 3), dtype=torch.bfloat16,
                                          device="meta"),
                       "blocks": {"qw": torch.zeros((2, 4, 3),
                                                    dtype=torch.int8)}},
            "g": torch.empty((7,), device="meta")}
    back = restore(str(tmp_path), like, device="cpu")
    assert back["params"]["emb"].dtype == torch.bfloat16
    assert np.array_equal(bits16(back["params"]["emb"]),
                          bits16(jtree["params"]["emb"]))
    assert back["params"]["blocks"]["qw"].dtype == torch.int8
    assert np.array_equal(back["params"]["blocks"]["qw"].numpy(),
                          src["params"]["blocks"]["qw"])
    assert back["g"].numpy().tobytes() == src["g"].tobytes()


def test_restore_of_a_meta_tree_needs_the_card(tmp_path, monkeypatch):
    save(str(tmp_path), 1, {"a": torch.zeros((2,))})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore(str(tmp_path), {"a": torch.empty((2,), device="meta")})
