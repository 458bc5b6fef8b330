"""The port's ``--offset`` model held against the JAX model, on the CPU.

Same weights on both sides (every JAX param and batch statistic seeded, then
carried into the port by ``from_jax_variables``), same seeded numpy inputs.
The JAX side is kept cheap: 32x48 planes, ``prop_time`` 3, ``offset_window``
2 (and 0, the exact gather, in one training case) and its neighbour scan (``offset_neighbor_loop='scan'``, the same math as
the unrolled window in fewer XLA ops). The offset head's weights are scaled
so that the offsets either stay inside the window (JAX's eval takes its
windowed branch) or escape it (its exact branch; in training the clamp).

Tolerances as ``test_torch_model.py`` and ``test_torch_train.py``: forward
2e-4 of max(max |output|, 1); loss 1e-4; each gradient 5e-3 norm-relative;
BatchNorm statistics 2e-4.
"""

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.losses import get_loss as jax_get_loss
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu.train import check_offset_telemetry as jax_telemetry
from nlspn_eccv20_tpu.utils.torch_import import import_nlspn_state_dict
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.train import Engine, check_offset_telemetry
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables, randomize_
from test_torch_model import TINY, assert_forward_close, nchw, sample
from test_torch_train import (
    BN_TOL, GRAD_TOL, LOSS_TOL, assert_trees_close, grads_as_jax_tree,
    init_variables, norm_rel_err, rel_err, to_port, train_batch)

H, W = 32, 48
OFFSET = dict(TINY, offset=True, offset_window=2, offset_neighbor_loop="scan")


@pytest.fixture(scope="module")
def offset_model():
    jcfg = JaxConfig(**OFFSET)
    jmodel, variables = init_variables(jcfg, H, W)
    return jcfg, jmodel, variables


def with_offset_scale(variables, jcfg, scale):
    """The variables with the offset channels of the off_aff head (the
    first 2 N of its 3 N outputs) scaled by ``scale``."""
    n2 = 2 * jcfg.num_neighbors
    heads = dict(variables["params"]["heads"])
    for name in ("off_aff_dec0_kernel", "off_aff_dec0_bias"):
        v = np.array(heads[name])
        v[..., :n2] *= scale
        heads[name] = v
    return {"params": dict(variables["params"], heads=heads),
            "batch_stats": variables["batch_stats"]}


def port_model(jcfg, variables):
    cfg = Config(**dataclasses.asdict(jcfg))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    return cfg, model


@pytest.mark.parametrize("scale,escapes", [(0.3, False), (3.0, True)])
def test_eval_forward_matches_jax(offset_model, scale, escapes):
    jcfg, jmodel, variables = offset_model
    variables = with_offset_scale(variables, jcfg, scale)
    s = sample(2, H, W, seed=2)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, s)
    off_max = float(jnp.max(jnp.abs(ref["offset"])))
    assert (off_max > jcfg.offset_window) == escapes, off_max
    _, model = port_model(jcfg, variables)
    with torch.inference_mode():
        out = model({"rgb": torch.from_numpy(nchw(s["rgb"])),
                     "dep": torch.from_numpy(nchw(s["dep"]))})
    assert out["offset"].shape == (2, 18, H, W)
    assert_forward_close("offset", out["offset"], nchw(ref["offset"]))
    for name in ("pred", "pred_init", "aff", "confidence"):
        assert_forward_close(name, out[name], nchw(ref[name]))
    for i, (p, r) in enumerate(zip(out["pred_inter"], ref["pred_inter"])):
        assert_forward_close(f"pred_inter[{i}]", p, nchw(r))
    mask = nchw(s["dep"] > 0)
    assert np.array_equal(out["pred"].numpy()[mask], nchw(s["dep"])[mask])


# Batch seeds with no ReLU input within the two frameworks' BatchNorm noise
# of zero (see test_torch_train.py's note on seeds).
@pytest.mark.parametrize("scale,escapes,seed,window", [
    (0.3, False, 4, 2), (3.0, True, 4, 2),
    (3.0, True, 4, 0),     # offset_window 0: the exact gather, unclamped
])
def test_train_step_matches_jax(offset_model, scale, escapes, seed, window):
    """One Engine step against jax.value_and_grad of the JAX train-mode
    loss: loss, every gradient, the BatchNorm statistics and off_max. With
    escaping offsets the clamp cuts the gradient of those beyond the window
    and halves it at the edge; at window 0 nothing is clamped and both
    differentiate the exact gather."""
    jcfg, jmodel, variables = offset_model
    if window != jcfg.offset_window:
        jcfg = dataclasses.replace(jcfg, offset_window=window)
        jmodel = jax_get_model(jcfg)
    variables = with_offset_scale(variables, jcfg, scale)
    batch = train_batch(2, H, W, seed=seed)
    jloss = jax_get_loss(jcfg)

    def loss_of(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, need_inter=False, mutable=["batch_stats"])
        return jloss(batch, out)[0] / 2, (mut["batch_stats"],
                                          jnp.max(jnp.abs(out["offset"])))

    (ref_loss, (ref_stats, ref_off_max)), ref_grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(variables["params"])
    assert (float(ref_off_max) > jcfg.offset_window) == escapes

    cfg = Config(**dataclasses.asdict(jcfg))
    eng = Engine(cfg, device="cpu")
    eng.init_state(from_jax_variables(variables, cfg))
    aux = eng.train_step(to_port(batch))

    assert rel_err(aux["loss"].item(), ref_loss) <= LOSS_TOL
    assert rel_err(aux["off_max"].item(), ref_off_max) <= 1e-5
    back = grads_as_jax_tree(eng.model, variables, jcfg)
    assert_trees_close(back["params"], ref_grads, GRAD_TOL, "gradient",
                       norm_rel_err)
    assert_trees_close(back["batch_stats"], ref_stats, BN_TOL, "BN statistics")
    off_grad = ref_grads["heads"]["off_aff_dec0_kernel"][..., :2 * cfg.num_neighbors]
    assert np.any(np.asarray(off_grad) != 0.0)


def test_bridge_round_trip_is_exact(offset_model):
    """The 3 N-channel off_aff head survives port state_dict ->
    import_nlspn_state_dict -> the same JAX tree."""
    jcfg, _, variables = offset_model
    cfg, model = port_model(jcfg, variables)
    assert model.state_dict()["off_aff_dec0.0.weight"].shape[0] == 3 * cfg.num_neighbors
    back = import_nlspn_state_dict(jax.tree_util.tree_map(np.zeros_like, variables),
                                   model.state_dict(), jcfg)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_offset_head_is_zero_initialised_and_window_0_does_not_train():
    """The offset head starts at zero; at offset_window=0 the model gathers
    exactly in eval and in training, where its unclamped offsets get a
    gradient."""
    cfg = Config(**OFFSET)
    model = get_model(cfg, device="cpu")
    for k in ("off_aff_dec0.0.weight", "off_aff_dec0.0.bias"):
        assert model.state_dict()[k].shape[0] == 24
        assert torch.count_nonzero(model.state_dict()[k]) == 0, k
    model = randomize_(get_model(cfg.replace(offset_window=0), device="cpu"),
                       torch.Generator().manual_seed(0))
    s = {"rgb": torch.from_numpy(nchw(sample(1, 16, 16)["rgb"])),
         "dep": torch.from_numpy(nchw(sample(1, 16, 16)["dep"]))}
    with torch.no_grad():
        ref = model(s)
    assert ref["offset"].shape == (1, 18, 16, 16)           # eval: exact
    out = model.train()(s, need_inter=False)
    out["pred"].sum().backward()
    grad = model.off_aff_dec0[0].weight.grad[:2 * cfg.num_neighbors]
    assert torch.isfinite(grad).all() and torch.count_nonzero(grad) > 0


@contextlib.contextmanager
def no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield


@pytest.mark.parametrize("off_max,fires", [(1.5, False), (1.7, True), (3.0, True)])
def test_offset_telemetry_matches_jax(off_max, fires):
    kw = dict(offset=True, offset_window=2)
    with pytest.warns(UserWarning) if fires else no_warning():
        assert check_offset_telemetry(Config(**kw), off_max, 3) is fires
    with pytest.warns(UserWarning) if fires else no_warning():
        assert jax_telemetry(JaxConfig(**kw), off_max, 3) is fires
    assert check_offset_telemetry(Config(offset=False), off_max) is False
