"""The port stands alone: no file of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or the reference package, and its entry points run on the card
unless the caller asks for the CPU — they never fall back to it quietly."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.quantize import calibration_samples
from repro_torch.models.api import get_model
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (ContinuousEngine, CyclicDecoder, Engine,
                                 GroupedStreamEngine, ModelGroup,
                                 StreamEngine)
from repro_torch.sim import (ReconstructionHead, build_autoencoder,
                             build_detector, recalibrate_threshold,
                             score_windows, train_autoencoder, train_detector,
                             train_forecaster, train_one_class)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield arg.value


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 15


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_detector()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_params(torch.Generator().manual_seed(0))
    cpu_params = model.init_params(torch.Generator().manual_seed(0),
                                   device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamEngine(model, cpu_params, n_streams=2)
    groups = [ModelGroup(name, model, cpu_params, 2) for name in ("a", "b")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GroupedStreamEngine(groups)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({1: {"w": np.zeros((2, 2), np.float32)}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibration_samples(np.zeros((4, 400), np.float32))
    x = np.zeros((8, 400), np.float32)
    y = np.zeros(8, np.int64)
    for train in (train_detector, train_autoencoder, train_one_class,
                  train_forecaster):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(x, y)
    ae = build_autoencoder()
    ae_params = ae.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        score_windows(ae, ae_params, ReconstructionHead(), x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recalibrate_threshold(ae, ae_params, x)
    # The explicit CPU request is honoured.
    assert StreamEngine(model, cpu_params, n_streams=2,
                        device="cpu").device.type == "cpu"
    assert GroupedStreamEngine(groups, device="cpu").device.type == "cpu"
    assert score_windows(ae, ae_params, ReconstructionHead(), x,
                         device="cpu").shape == (8,)


def test_llm_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = get_model(get_config("mamba2_370m").reduced().with_(
        dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init(torch.Generator().manual_seed(0))
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(api, params, batch_slots=2, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(api, params, batch_slots=2, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CyclicDecoder(api.cfg, params, n_segments=2, batch=1, cache_len=8)
    # The explicit CPU request is honoured.
    engine = Engine(api, params, batch_slots=2, cache_len=8, device="cpu")
    assert engine.device.type == "cpu"
    assert engine.cache["ssm"].device.type == "cpu"
    assert ContinuousEngine(api, params, batch_slots=2, cache_len=8,
                            device="cpu").cache["ssm"].device.type == "cpu"
    assert CyclicDecoder(api.cfg, params, n_segments=2, batch=1, cache_len=8,
                         device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ("qwen3_8b", "granite_moe_1b_a400m"))
def test_dense_and_moe_entry_points_refuse_to_fall_back_to_cpu(arch,
                                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = get_model(get_config(arch).reduced().with_(dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_cache(2, 8)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    for engine in (Engine, ContinuousEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(api, params, batch_slots=2, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CyclicDecoder(api.cfg, params, n_segments=2, batch=1, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", arch, "--reduced"])
    assert api.init_cache(2, 8, device="cpu")["k"].device.type == "cpu"


@pytest.mark.parametrize("arch", ("jamba_1_5_large_398b", "llava_next_34b",
                                  "whisper_base"))
def test_family_entry_points_refuse_to_fall_back_to_cpu(arch, monkeypatch):
    """The hybrid, vlm and audio families: init, init_cache, init_batch,
    the wave Engine with its extras and the launcher raise without CUDA;
    the explicit CPU request is honoured."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = get_model(get_config(arch).reduced().with_(dtype=torch.float32))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init(gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_batch("prefill", 2, 8, gen)
    params = api.init(gen, device="cpu")
    extras = {k: v for k, v in api.init_batch("prefill", 2, 8, gen,
                                              device="cpu").items()
              if k != "tokens"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(api, params, batch_slots=2, cache_len=32, extras=extras)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", arch, "--reduced"])
    engine = Engine(api, params, batch_slots=2, cache_len=32, extras=extras,
                    device="cpu")
    assert all(v.device.type == "cpu" for v in engine.extras.values())
    assert engine.cache["k"].device.type == "cpu"
