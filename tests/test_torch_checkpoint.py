"""Checkpoints, reference weights and the ImageNet backbone in the port.

The port's checkpoints round-trip, keep the last epoch only and hold the
weights alone for a non-final ``--no_save_full`` epoch, ``steps_per_epoch``
in both kinds. Held against the JAX package on the CPU (tiny model, small
patches, few steps): a port checkpoint read by the JAX package's own
``load_nlspn_torch_checkpoint`` gives the JAX forward the port's forward
within 2e-4; a reference-format ``.pt`` served through both packages'
``Predictor(checkpoint=...)`` gives the same predictions within 2e-4; a
torchvision-named ``resnet18.pth`` applied by both packages gives the same
encoder-stage outputs within 2e-4.
"""

import argparse
import dataclasses
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu.models.resnet import ResNetStage
from nlspn_eccv20_tpu.serve import Predictor as JaxPredictor
from nlspn_eccv20_tpu.utils.torch_import import (apply_resnet_pretrained,
                                                 load_nlspn_torch_checkpoint)
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.serve import Predictor
from nlspn_eccv20_tpu_torch.train import (Engine, init_backbone_pretrained,
                                          load_pretrained_params)
from nlspn_eccv20_tpu_torch.utils import torch_import
from nlspn_eccv20_tpu_torch.utils.checkpoint import CheckpointManager, load_weights
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables
from test_torch_model import TINY, assert_forward_close, nchw, random_variables, sample


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU training: the suite runs
    several workers at once on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

H, W = 32, 32
SMALL = dict(TINY, patch_height=H, patch_width=W, batch_size=2, epochs=2)


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX tiny model with seeded random weights (every leaf non-zero),
    initialised under one jit (an eager init compiles op by op)."""
    jcfg = JaxConfig(**SMALL)
    model = jax_get_model(jcfg)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in sample(1, H, W).items()})
    return jcfg, model, random_variables(jax.device_get(variables), 1)


@pytest.fixture(scope="module")
def engine(jax_setup):
    jcfg, _, variables = jax_setup
    cfg = Config(**dataclasses.asdict(jcfg))
    eng = Engine(cfg, steps_per_epoch=5, device="cpu")
    eng.init_state(from_jax_variables(variables, cfg))
    return eng


def states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], dict):
            states_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_round_trip_keep_last_and_weights_only(engine, tmp_path):
    cfg = dataclasses.replace(engine.cfg, save_dir=str(tmp_path))
    ckpt = CheckpointManager(cfg)
    assert ckpt.latest_epoch() is None
    state = engine.checkpoint_state()
    ckpt.save(1, state, full=False)
    weights_only = ckpt.restore(1)
    assert set(weights_only) == {"net", "steps_per_epoch"}
    assert weights_only["steps_per_epoch"] == 5
    ckpt.save(2, state, full=True)
    assert ckpt.epochs() == [2] and ckpt.latest_epoch() == 2        # keep-last-1
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["model_00002.pt"]
    full = ckpt.restore()
    assert set(full) == {"net", "optimizer", "step", "steps_per_epoch", "args"}
    states_equal({k: full[k] for k in state}, state)
    assert Config.from_json(full["args"]) == cfg
    assert CheckpointManager.load_config(str(tmp_path)) == cfg.finalize()


def test_restore_names_the_bridge_for_orbax_directories(engine, tmp_path):
    ckpt = CheckpointManager(engine.cfg, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore()
    (tmp_path / "ckpt" / "3" / "default").mkdir(parents=True)   # Orbax's layout
    with pytest.raises(ValueError, match="from_jax_variables"):
        ckpt.restore()


@pytest.fixture(scope="module")
def port_checkpoint(engine, tmp_path_factory):
    run = tmp_path_factory.mktemp("run")
    cfg = dataclasses.replace(engine.cfg, save_dir=str(run))
    return run, CheckpointManager(cfg).save(1, engine.checkpoint_state())


def test_jax_reads_a_port_checkpoint(jax_setup, engine, port_checkpoint):
    """The JAX package's own loader takes the port's file as it is."""
    jcfg, model, variables = jax_setup
    run, path = port_checkpoint
    loaded = load_nlspn_torch_checkpoint(variables, path, jcfg)
    x = sample(2, H, W, seed=5)
    ref = model.apply(loaded, {k: jnp.asarray(v) for k, v in x.items()},
                      train=False)
    port = get_model(engine.cfg, "cpu")
    load_pretrained_params(port, load_weights(engine.cfg, str(run)))
    with torch.no_grad():
        out = port({k: torch.from_numpy(nchw(v)) for k, v in x.items()})
    for key in ("pred", "pred_init"):
        assert_forward_close(key, out[key], nchw(ref[key]))


@pytest.fixture(scope="module")
def reference_pt(engine, tmp_path_factory):
    """A checkpoint as the reference saves it: DistributedDataParallel's
    ``module.`` names, its frozen gather weights, an argparse Namespace."""
    sd = {"module." + k: v.clone() for k, v in engine.model.state_dict().items()}
    sd.update({"module.w": torch.ones(1, 1, 3, 3), "module.b": torch.zeros(1),
               "module.w_conf": torch.ones(1, 1, 3, 3)})
    path = str(tmp_path_factory.mktemp("ref") / "model_00020.pt")
    torch.save({"net": sd, "args": argparse.Namespace(prop_time=3, lr=1e-3),
                "optimizer": None}, path)
    return path


def test_reference_pt_served_by_both_predictors(jax_setup, engine, reference_pt):
    jcfg, _, _ = jax_setup
    port = Predictor(engine.cfg, checkpoint=reference_pt, device="cpu")
    ref = JaxPredictor(jcfg, checkpoint=reference_pt)
    rng = np.random.default_rng(6)
    rgbs = [rng.integers(0, 256, (30, 28, 3), dtype=np.uint8) for _ in range(2)]
    deps = [((rng.random((30, 28)) > 0.9) * rng.uniform(0.5, 5.0, (30, 28))
             ).astype(np.float32) for _ in range(2)]
    for got, want in zip(port.predict_batch(rgbs, deps), ref.predict_batch(rgbs, deps)):
        assert got.shape == want.shape == (30, 28)
        assert np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0) < 2e-4
    port.warmup([(20, 24)])


def test_predictor_checkpoint_forms_agree(engine, port_checkpoint, reference_pt):
    """A port experiment directory, its .pt and the reference file load the
    same weights as the state_dict itself."""
    run, path = port_checkpoint
    want = engine.model.state_dict()
    for src in (str(run), path, reference_pt):
        got = Predictor(engine.cfg, checkpoint=src, device="cpu").model.state_dict()
        states_equal(got, want)
    got = torch_import.load_nlspn_torch_checkpoint(get_model(engine.cfg, "cpu"),
                                                   reference_pt)
    states_equal(got.state_dict(), want)
    with pytest.raises(ValueError, match="need `state_dict` or `checkpoint`"):
        Predictor(engine.cfg, device="cpu")


def test_load_pretrained_params_missing_raises_unexpected_warns(engine):
    model = get_model(engine.cfg, "cpu")
    sd = engine.model.state_dict()
    with pytest.raises(KeyError, match="missing"):
        load_pretrained_params(model, {k: v for k, v in sd.items()
                                       if not k.startswith("GRU.")})
    extra = dict(sd, stray=torch.zeros(1))
    with pytest.warns(UserWarning, match="stray"):
        load_pretrained_params(model, extra)
    states_equal(model.state_dict(), sd)
    with pytest.raises(KeyError, match="unexpected"):
        load_pretrained_params(model, extra, strict=True)


def fake_torchvision_resnet18(path):
    """Seeded tensors under torchvision's resnet18 names (stem, 4 layers, fc)."""
    g = torch.Generator().manual_seed(11)
    sd = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=g),
          "fc.weight": torch.randn(1000, 512, generator=g), "fc.bias": torch.zeros(1000)}

    def bn(pre, c):
        sd[pre + "weight"] = 0.5 + torch.rand(c, generator=g)
        sd[pre + "bias"] = 0.1 * torch.randn(c, generator=g)
        sd[pre + "running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[pre + "running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[pre + "num_batches_tracked"] = torch.tensor(100)

    bn("bn1.", 64)
    c_in = 64
    for layer, c in zip(range(1, 5), (64, 128, 256, 512)):
        for b in range(2):
            pre = f"layer{layer}.{b}."
            cin = c_in if b == 0 else c
            sd[pre + "conv1.weight"] = torch.randn(c, cin, 3, 3, generator=g) / (9 * cin) ** 0.5
            sd[pre + "conv2.weight"] = torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5
            bn(pre + "bn1.", c)
            bn(pre + "bn2.", c)
            if b == 0 and layer > 1:
                sd[pre + "downsample.0.weight"] = torch.randn(c, cin, 1, 1, generator=g) / cin ** 0.5
                bn(pre + "downsample.1.", c)
        c_in = c
    torch.save(sd, path)
    return sd


def test_backbone_init_matches_jax(jax_setup, engine, tmp_path):
    jcfg, _, variables = jax_setup
    tv = fake_torchvision_resnet18(str(tmp_path / "resnet18.pth"))
    cfg = dataclasses.replace(engine.cfg, dir_pretrain_backbone=str(tmp_path))
    model = init_backbone_pretrained(cfg, get_model(cfg, "cpu"))
    sd = model.state_dict()
    for k, v in tv.items():
        if k.startswith(("layer1.", "layer2.", "layer3.")):
            stage = "conv" + str(int(k[5]) + 1)
            assert torch.equal(sd[stage + k[6:]], v), k
    jvars = apply_resnet_pretrained(variables, str(tmp_path / "resnet18.pth"), "resnet18")

    x = np.random.default_rng(7).standard_normal((2, 16, 20, 64)).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(nchw(x))
    for name, features, nb, stride in (("conv2", 64, 2, 1), ("conv3", 128, 2, 2),
                                       ("conv4", 256, 2, 2)):
        jx = ResNetStage(features, nb, stride=stride).apply(
            {"params": jvars["params"][name], "batch_stats": jvars["batch_stats"][name]},
            jx, train=False)
        with torch.no_grad():
            px = getattr(model, name)(px)
        assert_forward_close(name, px, nchw(jx))


def test_backbone_init_warns_raises_or_skips(engine, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)       # no pretrained/ here
    model = get_model(engine.cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning, match="FROM SCRATCH"):
        init_backbone_pretrained(engine.cfg, model)
    with pytest.raises(FileNotFoundError, match="--dir_pretrain_backbone"):
        init_backbone_pretrained(
            dataclasses.replace(engine.cfg, dir_pretrain_backbone="elsewhere"), model)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        init_backbone_pretrained(dataclasses.replace(
            engine.cfg, from_scratch=True, dir_pretrain_backbone="elsewhere"), model)
    states_equal(model.state_dict(), before)


def test_initial_weights_are_a_function_of_the_seed():
    cfg = Config(**SMALL, seed=5)
    torch.manual_seed(0)
    a = Engine(cfg, device="cpu").model.state_dict()
    torch.manual_seed(1)
    torch.rand(100)
    b = Engine(cfg, device="cpu").model.state_dict()
    c = Engine(dataclasses.replace(cfg, seed=6), device="cpu").model.state_dict()
    states_equal(a, b)
    assert not torch.equal(a["conv2.0.conv1.weight"], c["conv2.0.conv1.weight"])
    assert not torch.equal(a["conv1_rgb.0.bias"], c["conv1_rgb.0.bias"])
    assert not a["off_aff_dec0.0.weight"].any()                # zero-initialised
    assert a["conv2.0.conv1.weight"].std() == pytest.approx((2 / (64 * 9)) ** 0.5, rel=0.1)
