"""The port's constant-affinity model (``use_GRU=False``,
``prop_impl='pallas'``) held against the JAX model, on the CPU.

With ``need_inter=False`` both packages run the whole propagation loop as
one whole-loop op: the JAX model its Pallas ``_loop_kernel`` (interpret
mode on the CPU) and the port ``prop_loop`` (its plain version on CPU
tensors). Same weights on both sides (seeded, carried into the port by
``from_jax_variables``), same seeded numpy inputs. Tolerances as
``test_torch_model.py`` and ``test_torch_train.py``: forward 2e-4 of
max(max |output|, 1); loss 1e-4; each gradient 5e-3 norm-relative;
BatchNorm statistics 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu_torch.models.nlspn as nlspn_mod
from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.losses import get_loss as jax_get_loss
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.train import Engine
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables, randomize_
from test_torch_model import TINY, assert_forward_close, nchw, port_model, sample
from test_torch_train import (
    BN_TOL, GRAD_TOL, LOSS_TOL, assert_trees_close, grads_as_jax_tree,
    init_variables, norm_rel_err, rel_err, to_port, train_batch)

LOOP = dict(TINY, use_GRU=False, prop_impl="pallas")


@pytest.mark.parametrize("kw,h,w", [
    ({}, 32, 48),
    ({"always_clip": True, "conf_prop": False, "prop_kernel": 5}, 30, 44),
])
def test_eval_forward_matches_jax(kw, h, w):
    jcfg = JaxConfig(**LOOP, **kw)
    jmodel, variables = init_variables(jcfg, h, w)
    assert jmodel._use_loop_kernel(False, False, h, w)
    s = sample(2, h, w, seed=2)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, need_inter=False))(
        variables, s)
    model = port_model(jcfg, variables)
    with torch.inference_mode():
        out = model({"rgb": torch.from_numpy(nchw(s["rgb"])),
                     "dep": torch.from_numpy(nchw(s["dep"]))}, need_inter=False)
    assert out["pred_inter"] == [] and ref["pred_inter"] == []
    for name in ("pred", "pred_init", "aff") + (("confidence",) if jcfg.conf_prop else ()):
        assert_forward_close(name, out[name], nchw(ref[name]))
    mask = nchw(s["dep"] > 0)
    assert np.array_equal(out["pred"].numpy()[mask], nchw(s["dep"])[mask])


def jax_uses_loop_kernel(jcfg, need_inter):
    return jax_get_model(jcfg)._use_loop_kernel(need_inter, False, 16, 24)


@pytest.mark.parametrize("prop_impl,need_inter,train,loop", [
    ("pallas", False, False, True),    # serving
    ("pallas", False, True, True),     # training
    ("pallas", True, False, False),    # per-step outputs asked for
    ("auto", False, False, False),     # 'auto' keeps a step kernel a step
    ("xla", False, True, False),
])
def test_route_is_the_jax_packages(monkeypatch, prop_impl, need_inter, train, loop):
    """The whole loop runs as one prop_loop exactly where JAX's
    _use_loop_kernel takes its loop kernel, and then no prop_step runs."""
    calls = {"prop_loop": 0, "prop_step": 0}
    for name in calls:
        fn = getattr(nlspn_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(nlspn_mod, name, counted)
    cfg = Config(**dict(LOOP, prop_impl=prop_impl))
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    assert jax_uses_loop_kernel(jcfg, need_inter) is loop
    model = randomize_(get_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    model.train(train)
    s = sample(1, 16, 24)
    out = model({"rgb": torch.from_numpy(nchw(s["rgb"])),
                 "dep": torch.from_numpy(nchw(s["dep"]))}, need_inter=need_inter)
    assert calls == ({"prop_loop": 1, "prop_step": 0} if loop else
                     {"prop_loop": 0, "prop_step": cfg.prop_time})
    assert len(out["pred_inter"]) == (0 if loop else cfg.prop_time)


def test_train_step_matches_jax():
    """One Engine step against jax.value_and_grad of the JAX train-mode loss
    through its loop kernel (custom VJP through the pure mirror): loss,
    every gradient, the BatchNorm statistics."""
    h, w = 32, 48
    jcfg = JaxConfig(**LOOP)
    jmodel, variables = init_variables(jcfg, h, w)
    batch = train_batch(2, h, w, seed=4)
    jloss = jax_get_loss(jcfg)

    def loss_of(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, need_inter=False, mutable=["batch_stats"])
        return jloss(batch, out)[0] / 2, (mut["batch_stats"], out["pred_inter"])

    (ref_loss, (ref_stats, ref_inter)), ref_grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(variables["params"])
    assert ref_inter == []                 # JAX took its loop kernel

    cfg = Config(**dataclasses.asdict(jcfg))
    eng = Engine(cfg, device="cpu")
    eng.init_state(from_jax_variables(variables, cfg))
    aux = eng.train_step(to_port(batch))
    assert aux["output"]["pred_inter"] == []
    assert rel_err(aux["loss"].item(), ref_loss) <= LOSS_TOL
    back = grads_as_jax_tree(eng.model, variables, jcfg)
    assert_trees_close(back["params"], ref_grads, GRAD_TOL, "gradient",
                       norm_rel_err)
    assert_trees_close(back["batch_stats"], ref_stats, BN_TOL, "BN statistics")
    assert float(jnp.abs(ref_grads["aff_scale_const"][0])) > 0.0
