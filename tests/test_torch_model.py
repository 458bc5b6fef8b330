"""The PyTorch port's model held against the JAX model, on the CPU.

Both get the same seeded numpy inputs and the same weights: every JAX param
and batch statistic is overwritten with seeded values (so no head is
zero-initialised and every affinity is non-trivial), then carried into the
port by ``utils.weights.from_jax_variables``. On the CPU the port runs its
kernels' plain PyTorch versions. Forward outputs must agree to PARITY.md's
forward bar: max abs error / max(max |output|, 1) < 2e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu.utils.torch_import import import_nlspn_state_dict
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables, randomize_

TINY = dict(GRU_hidden_dim=16, GRU_input_dim=16, prop_time=3,
            compile_cache=False)
FORWARD_TOL = 2e-4


def random_variables(variables, seed):
    """Seeded values for every leaf, scaled to keep activations O(1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "aff_scale_const":
            v = rng.uniform(1.0, 5.0, shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("mean",) or name.endswith("bias"):
            v = rng.standard_normal(shape) * 0.1
        else:  # kernels, HWIO
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


def sample(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    dep = (rng.random((b, h, w, 1)) > 0.9) * rng.uniform(0.5, 5.0, (b, h, w, 1))
    return {"rgb": rng.standard_normal((b, h, w, 3)).astype(np.float32),
            "dep": dep.astype(np.float32)}


def jax_model_and_variables(cfg_kw, h, w, seed=1):
    jcfg = JaxConfig(**cfg_kw)
    model = jax_get_model(jcfg)
    variables = model.init(jax.random.PRNGKey(0), sample(1, h, w), train=False)
    return jcfg, model, random_variables(variables, seed)


def port_model(jcfg, variables):
    cfg = Config(**dataclasses.asdict(jcfg))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    return model


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def assert_forward_close(name, port, ref):
    port = port.numpy()
    assert port.shape == ref.shape, name
    err = np.max(np.abs(port - ref))
    scale = max(np.max(np.abs(port)), 1.0)
    assert err / scale < FORWARD_TOL, f"{name}: max abs err {err} (scale {scale})"


@pytest.mark.parametrize("kw,h,w", [
    ({}, 32, 48),                          # fork default, aligned
    ({}, 30, 44),                          # fork default, unaligned
    ({"use_GRU": False}, 32, 48),
    ({"conf_prop": False}, 30, 44),
    ({"prop_kernel": 5}, 32, 48),
])
def test_forward_matches_jax(kw, h, w):
    jcfg, jmodel, variables = jax_model_and_variables({**TINY, **kw}, h, w)
    s = sample(2, h, w, seed=2)
    ref = jmodel.apply(variables, s, train=False)
    model = port_model(jcfg, variables)
    with torch.inference_mode():
        out = model({"rgb": torch.from_numpy(nchw(s["rgb"])),
                     "dep": torch.from_numpy(nchw(s["dep"]))})

    names = ["pred", "pred_init", "aff"]
    if jcfg.conf_prop:
        names.append("confidence")
    else:
        assert out["confidence"] is None
    for name in names:
        assert_forward_close(name, out[name], nchw(ref[name]))
    assert len(out["pred_inter"]) == len(ref["pred_inter"]) == jcfg.prop_time
    for i, (p, r) in enumerate(zip(out["pred_inter"], ref["pred_inter"])):
        assert_forward_close(f"pred_inter[{i}]", p, nchw(r))
    assert float(out["gamma"]) == pytest.approx(float(ref["gamma"][0]), rel=1e-6)
    # preserve_input pins every observed pixel exactly
    mask = nchw(s["dep"] > 0)
    assert np.array_equal(out["pred"].numpy()[mask], nchw(s["dep"])[mask])


@pytest.mark.parametrize("kw", [{}, {"use_GRU": False, "use_S2D": False,
                                     "conf_prop": False, "network": "resnet34"}])
def test_bridge_round_trip_is_exact(kw):
    """port state_dict -> import_nlspn_state_dict -> the same JAX tree."""
    jcfg, jmodel, variables = jax_model_and_variables({**TINY, **kw}, 32, 32)
    model = port_model(jcfg, variables)
    # a template with other values, so that every leaf must be written
    template = random_variables(variables, seed=99)
    back = import_nlspn_state_dict(template, model.state_dict(), jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_state_dict_names_are_the_reference_names():
    model = get_model(Config(**TINY), device="cpu")
    keys = set(model.state_dict())
    for k in ("conv1_rgb.0.weight", "S2D.pool_convs.0.0.weight",
              "S2D.pool_convs.1.0.bias", "S2D.conv.0.weight",
              "conv2.0.conv1.weight", "conv3.0.downsample.1.running_var",
              "conv5.0.weight", "conv5.1.running_mean", "dec4.0.weight",
              "dec2.1.weight", "id_dec1.0.weight", "off_aff_dec0.0.bias",
              "cf_dec1.1.running_var", "encode_aff.2.0.weight",
              "encode_dep.0.0.weight", "decode_aff.2.0.bias",
              "GRU.convz.weight", "GRU.convr.bias", "GRU.convq.weight",
              "aff_scale_const"):
        assert k in keys, k
    assert model.state_dict()["decode_aff.1.0.weight"].shape == (32, 16, 3, 3)
    assert model.state_dict()["aff_scale_const"].shape == (1,)


def test_zero_init_aff_zeroes_the_affinity_heads():
    model = get_model(Config(**TINY), device="cpu")
    for k in ("off_aff_dec0.0.weight", "off_aff_dec0.0.bias",
              "decode_aff.2.0.weight", "decode_aff.2.0.bias"):
        assert torch.count_nonzero(model.state_dict()[k]) == 0, k
    randomize_(model, torch.Generator().manual_seed(0))
    for k in ("off_aff_dec0.0.weight", "decode_aff.2.0.weight"):
        assert torch.count_nonzero(model.state_dict()[k]) > 0, k


def test_config_round_trips_and_validates_like_jax():
    jcfg = JaxConfig(prop_kernel=5, affinity="TC", use_GRU=False)
    cfg = Config(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_neighbors == 24
    assert [f.name for f in dataclasses.fields(Config)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    for bad in ({"prop_kernel": 4}, {"affinity": "XX"}, {"prop_time": -1},
                {"network": "resnet50"}, {"precision": "f16"}):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            Config(**bad)


@pytest.mark.parametrize("kw", [{"offset": True}, {"precision": "bf16"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        get_model(Config(**kw), device="cpu")


def test_training_forward_reaches_every_parameter():
    """A train-mode forward on the CPU gives a loss whose backward gives
    every trainable parameter a finite gradient: the kernels' autograd
    Functions pass gradients through the loop to every layer before it."""
    from nlspn_eccv20_tpu_torch.losses import LossFunction

    cfg = Config(**TINY)
    model = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(0)).train()
    s = sample(2, 32, 32)
    batch = {"rgb": torch.from_numpy(nchw(s["rgb"])),
             "dep": torch.from_numpy(nchw(s["dep"])),
             "gt": torch.from_numpy(nchw(s["dep"])) + 1.0}
    loss, _ = LossFunction(cfg)(batch, model(batch, need_inter=False))
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert torch.count_nonzero(p.grad) > 0, name
