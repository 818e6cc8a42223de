"""The port's sharding rules (``repro_torch.launch.shardings``) against the
reference's (``repro.launch.shardings``), and its activation hook on CPU gloo
ranks.

The rules are pure functions of a leaf's path and shape, the config's family
and the mesh's axis sizes, so the reference's ``param_spec``/``sanitize``
run here on a stand-in mesh (``test_sharding.FakeMesh``) and the port's spec
must equal the reference's ``PartitionSpec`` read as a tuple.  The cache and
batch layouts need a real JAX mesh in the reference (``NamedSharding``): they
are compared on its 1 x 1 host mesh, and checked by hand at 16 x 16.  The
hook redistributes DTensor activations on meshes of four spawned gloo ranks
(one module-scoped spawn; each test asserts its own case).
"""

import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ARCH_IDS
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.models import common as tcm

SIZES = {"data": 16, "model": 16}
WORLD = 4


def _jax_side():
    import jax
    from repro.configs import get_config as jget_config
    from repro.launch import shardings as jsh
    from jax.sharding import PartitionSpec as P
    from test_sharding import FakeMesh, MeshWrap
    return jax, jget_config, jsh, P, FakeMesh, MeshWrap


# The reference's own spec cases (test_sharding.TestParamSpecRules).
PARAM_CASES = {
    "embed": ("qwen3_8b", "embed/emb", (151936, 4096)),
    "wq": ("qwen3_8b", "blocks/attn/wq/w", (36, 4096, 4096)),
    "wo": ("qwen3_8b", "blocks/attn/wo/w", (36, 4096, 4096)),
    "w_up": ("qwen3_8b", "blocks/ffn/w_up/w", (36, 4096, 12288)),
    "w_down": ("qwen3_8b", "blocks/ffn/w_down/w", (36, 12288, 4096)),
    "moe_divisible": ("granite_moe_1b_a400m", "blocks/ffn/w_gate",
                      (24, 32, 1024, 512)),
    "moe_fallback_gate": ("mixtral_8x22b", "blocks/ffn/w_gate",
                          (56, 8, 6144, 16384)),
    "moe_fallback_down": ("mixtral_8x22b", "blocks/ffn/w_down",
                          (56, 8, 16384, 6144)),
    "norm": ("qwen3_8b", "blocks/ln1/g", (36, 4096)),
    "hybrid_double_stack": ("jamba_1_5_large_398b",
                            "blocks/mamba/mixer/in_proj/w",
                            (9, 7, 8192, 35072)),
    "router": ("mixtral_8x22b", "blocks/ffn/router", (56, 6144, 8)),
    "sint_scale": ("qwen3_8b", "blocks/attn/wq/w_scale", (36, 4096)),
    "out_bias": ("qwen3_8b", "blocks/attn/wk/b", (36, 1024)),
    "in_bias": ("qwen3_8b", "blocks/attn/wo/b", (36, 4096)),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_param_spec_equals_reference(case):
    from repro_torch.configs.base import get_config
    _, jget_config, jsh, _, FakeMesh, _ = _jax_side()
    arch, path, shape = PARAM_CASES[case]
    want = jsh.param_spec(path, shape, jget_config(arch), FakeMesh())
    got = tsh.param_spec(path, shape, get_config(arch), SIZES)
    assert got == tuple(want)


SANITIZE_CASES = {
    "nondivisible_dropped": (("model", None), (50280, 1024)),
    "divisible_kept": (("model", None), (65536, 1024)),
    "tuple_axes_kept": ((("data", "model"), None), (256, 8)),
    "tuple_axes_dropped": ((("data", "model"), None), (100, 8)),
    "short_spec_padded": (("model",), (64, 3, 5)),
}


@pytest.mark.parametrize("case", sorted(SANITIZE_CASES))
def test_sanitize_equals_reference(case):
    _, _, jsh, P, FakeMesh, _ = _jax_side()
    spec, shape = SANITIZE_CASES[case]
    assert tsh.sanitize(spec, shape, SIZES) == \
        tuple(jsh.sanitize(P(*spec), shape, FakeMesh()))


@pytest.mark.parametrize("sizes", ({"data": 2, "model": 4}, SIZES),
                         ids=("2x4", "16x16"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_of_every_leaf_equal_reference(arch, sizes):
    """Every leaf of the port's reduced param tree: the port's sanitized
    spec equals the reference's rules at the leaf's path and shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import get_model
    _, jget_config, jsh, _, FakeMesh, _ = _jax_side()
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    specs = tsh.param_shardings(params, cfg, sizes)
    mesh = FakeMesh(**sizes)
    leaves = list(tsh._paths(params))
    assert len(leaves) > 5
    got = dict(tsh._paths(specs))
    for path, leaf in leaves:
        shape = tuple(leaf.shape)
        want = jsh.sanitize(jsh.param_spec(path, shape, jcfg, mesh), shape,
                            mesh)
        assert got[path] == tuple(want), path


def test_opt_shardings_mirror_the_params():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.api import get_model
    cfg = get_config("qwen3_8b").reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    p_specs = tsh.param_shardings(params, cfg, {"data": 2, "model": 4})
    opt = make_optimizer()[0](params)
    got = tsh.opt_shardings(opt, p_specs, {"data": 2, "model": 4})
    assert got.step == ()
    assert dict(tsh._paths(got.mu)) == dict(tsh._paths(got.nu)) == \
        dict(tsh._paths(p_specs))
    assert any(s != (None,) * len(s) for _, s in tsh._paths(got.mu))


@pytest.mark.parametrize("arch,batch", (("qwen3_8b", 4), ("mamba2_370m", 1),
                                        ("jamba_1_5_large_398b", 2),
                                        ("whisper_base", 2)))
def test_cache_shardings_equal_reference_on_host_mesh(arch, batch):
    """The whole decode cache of each family, against the reference's
    ``cache_shardings`` on its 1 x 1 host mesh."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import get_model
    jax, jget_config, jsh, _, _, MeshWrap = _jax_side()
    from repro.models import get_model as jget_model
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    want = jsh.cache_shardings(jget_model(jcfg).cache_specs(batch, 16), jcfg,
                               MeshWrap(), batch_size=batch)
    got = tsh.cache_shardings(get_model(cfg).cache_specs(batch, 16), cfg,
                              {"data": 1, "model": 1}, batch_size=batch)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    want = {jsh._path_str(p): tuple(s.spec) for p, s in flat}
    assert dict(tsh._paths(got)) == want


def test_cache_shardings_context_parallel():
    from repro_torch.configs.base import get_config
    meta = lambda *s: torch.empty(s, device="meta")
    kv = tsh.cache_shardings({"k": meta(36, 128, 32768, 8, 128)},
                             get_config("qwen3_8b"), SIZES, batch_size=128)
    assert kv["k"] == (None, "data", "model", None, None)
    # batch 1: the sequence takes both axes, SSM heads "model"
    long = tsh.cache_shardings(
        {"k": meta(36, 1, 524288, 8, 128), "ssm": meta(48, 1, 32, 64, 128)},
        get_config("qwen3_8b"), SIZES, batch_size=1)
    assert long["k"] == (None, None, ("data", "model"), None, None)
    assert long["ssm"] == (None, None, "model", None, None)


def test_batch_shardings_equal_reference():
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import get_model
    jax, jget_config, jsh, _, _, MeshWrap = _jax_side()
    from repro.models import get_model as jget_model
    cfg, jcfg = (get_config("llava_next_34b").reduced(),
                 jget_config("llava_next_34b").reduced())
    want = jsh.batch_shardings(jget_model(jcfg).batch_specs("train", 4, 32),
                               MeshWrap(), batch_size=4)
    got = tsh.batch_shardings(get_model(cfg).batch_specs("train", 4, 32),
                              {"data": 1, "model": 1}, batch_size=4)
    assert got == {k: tuple(s.spec) for k, s in want.items()}
    sized = tsh.batch_shardings(get_model(cfg).batch_specs("train", 4, 32),
                                SIZES, batch_size=4)
    assert set(sized.values()) == {(None, None), (None, None, None)}
    sized = tsh.batch_shardings(get_model(cfg).batch_specs("train", 32, 32),
                                SIZES, batch_size=32)
    assert sized["tokens"] == ("data", None)


def test_to_placements():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert tsh.to_placements(("model", None), mesh) == (Replicate(),
                                                        Shard(0))
    assert tsh.to_placements((("data",), "model", None), mesh) == \
        (Shard(0), Shard(1))
    assert tsh.to_placements((("data", "model"), None), mesh) == \
        (Shard(0), Shard(0))
    assert tsh.to_placements((None, None), mesh) == (Replicate(),
                                                     Replicate())
    with pytest.raises(ValueError, match="lacks"):
        tsh.to_placements((("pod", "data"), None), mesh)
    with pytest.raises(ValueError, match="order"):
        tsh.to_placements((("model", "data"), None), mesh)
    with pytest.raises(ValueError, match="two dims"):
        tsh.to_placements(("model", "model"), mesh)


def test_input_shapes_equal_reference():
    from repro.configs.base import INPUT_SHAPES as JINPUT_SHAPES
    from repro_torch.configs.base import INPUT_SHAPES
    assert INPUT_SHAPES == JINPUT_SHAPES


def test_plain_tensors_pass_the_hook_unchanged():
    """With the hook installed, a model on plain tensors computes what it
    computes without one (the MoE's two "expert_in" points included)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import get_model
    cfg = get_config("granite_moe_1b_a400m").reduced().with_(
        dtype=torch.float32)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = api.init_batch("train", 2, 16, torch.Generator().manual_seed(1),
                           device="cpu")
    seen = []
    want = api.loss(params, batch)
    tsh.install_hook(types.SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 2)))
    inner = tcm._CONSTRAIN_HOOK
    tcm.set_constrain_hook(lambda x, name: seen.append(name) or inner(x,
                                                                     name))
    try:
        got = api.loss(params, batch)
        x = torch.ones(2, 3, 4)
        assert tcm.constrain(x, "btd") is x
    finally:
        tsh.install_hook(None)
    assert tcm._CONSTRAIN_HOOK is None
    assert torch.equal(got, want)
    assert seen.count("expert_in") == 2 * cfg.n_layers
    assert "btd" in seen


# ---------------------------------------------------------------------------
# The hook on DTensor activations, on spawned gloo ranks


def _rank_hook(rank, world):
    from torch.distributed.tensor import distribute_tensor
    torch.set_num_threads(1)
    meshes = {"1x2": tmesh.make_fleet_mesh(1, model_shards=2,
                                           device_type="cpu"),
              "2x2": tmesh.make_fleet_mesh(2, model_shards=2,
                                           device_type="cpu")}
    gen = torch.Generator().manual_seed(0)
    btd = torch.randn(4, 6, 8, generator=gen)
    expert = torch.randn(4, 2, 3, 8, generator=gen)
    odd = torch.randn(4, 3, 3, 8, generator=gen)
    out = {}
    for name, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        rep = [Replicate()] * 2
        for seq_parallel, batch_sharded in ((False, True), (True, True),
                                            (True, False)):
            hook = tsh.activation_hook(mesh, batch_sharded=batch_sharded,
                                       seq_parallel=seq_parallel)
            for what, x, label in (("btd", btd, "btd"),
                                   ("expert", expert, "expert_in"),
                                   ("odd_experts", odd, "expert_in")):
                y = hook(distribute_tensor(x, mesh, rep), label)
                out[(name, seq_parallel, batch_sharded, what)] = (
                    tuple(y.placements), torch.equal(y.full_tensor(), x),
                    tuple(y.to_local().shape))
        tsh.install_hook(mesh, seq_parallel=True)
        try:
            y = tcm.constrain(distribute_tensor(btd, mesh, rep), "btd")
            out[(name, "installed")] = tuple(y.placements)
        finally:
            tsh.install_hook(None)
    return out


@pytest.fixture(scope="module")
def hooked():
    return tmesh.spawn(_rank_hook, WORLD, "gloo", timeout=300.0)


@pytest.mark.parametrize("mesh", ("1x2", "2x2"))
def test_hook_redistributes_dtensor_activations(hooked, mesh):
    ranks = [r for r in hooked if any(k[0] == mesh for k in r)]
    assert len(ranks) == (2 if mesh == "1x2" else 4)
    s0, s1, rep = Shard(0), Shard(1), Replicate()
    data = 2 if mesh == "2x2" else 1
    for r in ranks:
        want = {
            (False, True, "btd"): ((s0, rep), (4 // data, 6, 8)),
            (True, True, "btd"): ((s0, s1), (4 // data, 3, 8)),
            (True, False, "btd"): ((rep, rep), (4, 6, 8)),
            (False, True, "expert"): ((s0, s1), (4 // data, 1, 3, 8)),
            (True, False, "expert"): ((rep, s1), (4, 1, 3, 8)),
            # 3 experts on a 2-way axis: no rule applies
            (True, True, "odd_experts"): ((rep, rep), (4, 3, 3, 8)),
        }
        for (seq, batch, what), (placements, local) in want.items():
            got = r[(mesh, seq, batch, what)]
            assert got == (placements, True, local), (seq, batch, what)
        assert r[(mesh, "installed")] == (s0, s1)
