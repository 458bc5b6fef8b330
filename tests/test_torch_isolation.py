"""The PyTorch port stands alone: no JAX, Flax or JAX-package import, and no
silent fall back to the CPU when there is no card (the CLI runs on the CPU
only with ``--platform cpu``)."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nlspn_eccv20_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nlspn_eccv20_tpu")


def port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_sources_found():
    rel = {os.path.relpath(p, REPO) for p in port_sources()}
    assert {"chip_smoke.py", "nlspn_eccv20_tpu_torch/serve.py",
            "nlspn_eccv20_tpu_torch/models/nlspn.py",
            "nlspn_eccv20_tpu_torch/main.py", "nlspn_eccv20_tpu_torch/data/nyu.py",
            "nlspn_eccv20_tpu_torch/utils/checkpoint.py",
            "nlspn_eccv20_tpu_torch/parallel/mesh.py", "nlspn_eccv20_tpu_torch/preflight.py",
            "nlspn_eccv20_tpu_torch/tools/generate_json_nyu.py",
            "nlspn_eccv20_tpu_torch/tools/generate_json_kitti_dc.py",
            "nlspn_eccv20_tpu_torch/tools/prepare_kitti_dc.py",
            "nlspn_eccv20_tpu_torch/utils/compile_cache.py"} <= rel


def test_entry_points_raise_without_a_card(monkeypatch):
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.models import get_model
    from nlspn_eccv20_tpu_torch.serve import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config(), checkpoint="no/such/run")   # the card is reported first
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(Config())


@pytest.mark.parametrize("platform", [None, "gpu"])
def test_main_raises_without_a_card_unless_asked_for_the_cpu(platform, monkeypatch,
                                                             tmp_path):
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.main import main, resolve_platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(platform=platform, data_name="Synthetic",
                 save_dir=str(tmp_path / "run")).finalize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(cfg)
    assert not (tmp_path / "run").exists()
    assert resolve_platform("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        resolve_platform("tpu")
