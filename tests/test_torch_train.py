"""The PyTorch port's train step held against the JAX package's, on the CPU.

Both sides get the same weights (every JAX param and batch statistic
overwritten with seeded values, carried into the port by
``from_jax_variables``) and the same seeded numpy batches. On the CPU the
port's kernels run their plain versions, forward and backward. Gradients
are carried back to the JAX tree by the JAX package's own
``import_nlspn_state_dict`` (it only transposes, flips and concatenates, so
it maps a gradient exactly as it maps a weight).

Tolerances (PARITY.md's bars; f32 sums in other orders): loss 1e-4
relative; each parameter's gradient ||port - jax|| / ||jax|| <= 5e-3, a
norm because a ReLU whose input lies within f32 noise of zero flips its
mask in one framework and not the other, which moves single entries by
their full size (see the seeds of the gradient test); each
BatchNorm running statistic after one step max |port - jax| / max |jax|
<= 2e-4; the 4-step trajectory 2e-2 (Adam's first steps move a weight by
about lr * sign(grad) wherever a gradient is near zero).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.data.synthetic import Synthetic as JaxSynthetic
from nlspn_eccv20_tpu.losses import get_loss as jax_get_loss
from nlspn_eccv20_tpu.metrics import evaluate as jax_evaluate
from nlspn_eccv20_tpu.metrics import evaluate_per_sample as jax_evaluate_ps
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu.parallel import replicate
from nlspn_eccv20_tpu.train import Engine as JaxEngine
from nlspn_eccv20_tpu.utils.optim import make_optimizer as jax_make_optimizer
from nlspn_eccv20_tpu.utils.torch_import import import_nlspn_state_dict
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic
from nlspn_eccv20_tpu_torch.losses import LossFunction
from nlspn_eccv20_tpu_torch.metrics import evaluate, evaluate_per_sample
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.train import Engine
from nlspn_eccv20_tpu_torch.utils.optim import make_optimizer, set_lr
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables
from test_torch_model import TINY, nchw, random_variables, sample

LOSS_TOL, GRAD_TOL, BN_TOL, TRAJ_TOL = 1e-4, 5e-3, 2e-4, 2e-2


def train_batch(b, h, w, seed):
    """rgb/dep as in the forward tests, and a gt with invalid (zero) pixels
    and depths past max_depth, so that both clips and the mask matter."""
    s = sample(b, h, w, seed)
    rng = np.random.default_rng(seed + 100)
    gt = rng.uniform(0.0, 12.0, (b, h, w, 1)) * (rng.random((b, h, w, 1)) > 0.2)
    s["gt"] = gt.astype(np.float32)
    return s


def to_port(batch):
    return {k: torch.from_numpy(nchw(v)) for k, v in batch.items()}


def init_variables(jcfg, h, w, seed=1):
    model = jax_get_model(jcfg)
    variables = jax.jit(lambda k: model.init(k, sample(1, h, w), train=False))(
        jax.random.PRNGKey(0))
    return model, random_variables(jax.device_get(variables), seed)


def port_from(jcfg, variables):
    cfg = Config(**dataclasses.asdict(jcfg))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    return cfg, model.train()


def grads_as_jax_tree(model, template, jcfg):
    """The port's .grad of every parameter (zeros where None), with the
    model's buffers, mapped onto the JAX {params, batch_stats} tree."""
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = p.grad if p.grad is not None else torch.zeros_like(p)
    return import_nlspn_state_dict(template, sd, jcfg)


def rel_err(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    return np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)), 1e-30)


def norm_rel_err(port, ref):
    port, ref = np.asarray(port).ravel(), np.asarray(ref).ravel()
    return np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30)


def assert_trees_close(port_tree, ref_tree, tol, what, err=rel_err):
    ref = dict(jax.tree_util.tree_leaves_with_path(ref_tree))
    port = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    assert port.keys() == ref.keys()
    worst = max((err(port[k], ref[k]), jax.tree_util.keystr(k))
                for k in ref if np.any(np.asarray(ref[k]) != 0))
    assert worst[0] <= tol, f"{what}: {worst[1]} rel err {worst[0]:.3e} > {tol}"


# The batch seeds are ones where no ReLU input lies within the two
# frameworks' BatchNorm noise of zero. Flax takes the batch variance as
# E[x^2] - E[x]^2 and torch in two passes, so normalised values differ by up
# to ~1e-5; at most seeds some ReLU mask then flips in one framework and not
# the other, and one flip at 1/8 resolution moves the gradient of every
# layer before it by 0.1-1.6% (seeds 3 and 5-11 did, on one case or more).
@pytest.mark.parametrize("kw,h,w,seed", [
    ({}, 32, 48, 4),                       # fork default, aligned
    ({}, 30, 44, 4),                       # fork default, unaligned
    ({"use_GRU": False}, 32, 48, 4),
    ({"conf_prop": False}, 30, 44, 12),
    ({"affinity": "TC"}, 32, 48, 4),       # aff_scale_const frozen
])
def test_loss_and_gradients_match_jax(kw, h, w, seed):
    jcfg = JaxConfig(**TINY, **kw)
    jmodel, variables = init_variables(jcfg, h, w)
    batch = train_batch(2, h, w, seed=seed)
    jloss = jax_get_loss(jcfg)

    def loss_of(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, need_inter=False, mutable=["batch_stats"])
        loss_sum, loss_val = jloss(batch, out)
        return loss_sum / 2, (mut["batch_stats"], loss_val / 2)

    (ref_loss, (ref_stats, ref_val)), ref_grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(variables["params"])

    cfg, model = port_from(jcfg, variables)
    s = to_port(batch)
    out = model(s, need_inter=False)
    loss_sum, loss_val = LossFunction(cfg)(s, out)
    loss = loss_sum / 2
    loss.backward()

    assert rel_err(loss.item(), ref_loss) <= LOSS_TOL
    assert rel_err(loss_val.detach().numpy() / 2, ref_val) <= LOSS_TOL
    back = grads_as_jax_tree(model, variables, jcfg)
    assert_trees_close(back["params"], ref_grads, GRAD_TOL, "gradient",
                       norm_rel_err)
    assert_trees_close(back["batch_stats"], ref_stats, BN_TOL, "BN statistics")
    if jcfg.affinity != "TGASS":
        assert model.aff_scale_const.grad is None
        assert float(ref_grads["aff_scale_const"][0]) == 0.0
    else:
        assert model.aff_scale_const.grad is not None


@pytest.fixture(scope="module")
def trajectory():
    """4 steps of the JAX Engine and of the port's on the same synthetic
    batches, steps_per_epoch=1 and decay '2,3': step 0 warms up, step 1
    crosses the first decay boundary."""
    h, w, b = 32, 48, 2
    kw = dict(TINY, batch_size=b, patch_height=h, patch_width=w,
              num_data_shards=1, decay="2,3", gamma="1.0,0.2", num_sample=60,
              data_name="Synthetic")
    jcfg = JaxConfig(**kw)
    jeng = JaxEngine(jcfg, steps_per_epoch=1)
    state = jax.device_get(jeng.init_state((h, w)))
    variables = random_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, seed=5)
    state = replicate(jeng.mesh, state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jeng.tx.init(variables["params"])))

    cfg = Config(**dataclasses.asdict(jcfg))
    eng = Engine(cfg, steps_per_epoch=1, device="cpu")
    eng.init_state(from_jax_variables(variables, cfg))

    data = Synthetic(cfg, "train")
    rng = np.random.default_rng(0)
    batches = [data.batch([2 * i, 2 * i + 1], rng) for i in range(4)]
    step = jeng.train_step_fn()
    ref, port = [], []
    for batch in batches:
        jb = {k: batch[k] for k in ("rgb", "dep", "gt")}
        state, aux = step(state, jeng.put_train_batch(jb))
        ref.append({k: np.asarray(jax.device_get(aux[k]))
                    for k in ("loss", "lr", "loss_val", "metric")})
        ref[-1]["pred"] = np.asarray(jax.device_get(aux["output"]["pred"]))
        pb = eng.put_batch(batch)
        a = eng.train_step(pb)
        port.append({"loss": a["loss"].item(), "lr": a["lr"],
                     "loss_val": a["loss_val"].numpy(),
                     "metric": a["metric"].numpy(),
                     "pred": a["output"]["pred"].numpy(),
                     "metric_of_port_pred": np.asarray(jax_evaluate(
                         {"gt": jnp.asarray(batch["gt"])},
                         {"pred": jnp.asarray(
                             a["output"]["pred"].permute(0, 2, 3, 1).numpy())}))})
    return jcfg, jeng, state, eng, ref, port, batches


# The metrics that move with pred by at most a bounded factor; iRMSE and
# iMAE (columns 2, 3) take 1 / pred, which with random weights lies near the
# 1e-4 validity floor and turns a 1e-5 difference in pred into a
# 1000-times larger one. Those two are held by computing the JAX metric on
# the port's own prediction instead.
LIPSCHITZ_METRICS = [0, 1, 4, 5, 6, 7]


def assert_metrics_close(port_rows, ref_rows, port_rows_by_jax, tol):
    port_rows, ref_rows = np.asarray(port_rows), np.asarray(ref_rows)
    assert rel_err(port_rows[..., LIPSCHITZ_METRICS],
                   ref_rows[..., LIPSCHITZ_METRICS]) <= tol
    np.testing.assert_allclose(port_rows, port_rows_by_jax, rtol=1e-5)


def test_trajectory_matches_jax_across_a_decay_boundary(trajectory):
    jcfg, jeng, state, eng, ref, port, _ = trajectory
    lrs = [p["lr"] for p in port]
    assert lrs == pytest.approx([1e-3, 2e-4, 2e-4, 2e-4], rel=1e-6)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p["lr"] == pytest.approx(float(r["lr"]), rel=1e-6), i
        assert rel_err(p["loss"], r["loss"]) <= TRAJ_TOL, (i, p["loss"], r["loss"])
        assert rel_err(p["loss_val"], r["loss_val"]) <= TRAJ_TOL, i
        assert rel_err(p["pred"], nchw(r["pred"])) <= TRAJ_TOL, i
        assert_metrics_close(p["metric"], r["metric"], p["metric_of_port_pred"],
                             TRAJ_TOL)
    assert eng.step == 4
    back = grads_as_jax_tree(eng.model, jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}), jcfg)
    sd_tree = import_nlspn_state_dict(back, eng.model.state_dict(), jcfg)
    assert_trees_close(sd_tree["params"], jax.device_get(state.params),
                       TRAJ_TOL, "parameters after 4 steps")
    assert_trees_close(sd_tree["batch_stats"], jax.device_get(state.batch_stats),
                       TRAJ_TOL, "BN statistics after 4 steps")


def test_eval_step_matches_jax(trajectory):
    """Eval-mode rows after the 4 steps: per-image loss and metrics."""
    _, jeng, state, eng, _, _, batches = trajectory
    batch = batches[0]
    jb = {k: batch[k] for k in ("rgb", "dep", "gt")}
    ref = jeng.eval_step_fn()(state, jeng.put_eval_batch(jb))
    out = eng.eval_step(eng.put_batch(batch))
    assert eng.model.training  # back in train mode
    assert out["loss_val"].shape == (2, 3) and out["metric"].shape == (2, 8)
    assert rel_err(out["loss_val"].numpy(), jax.device_get(ref["loss_val"])) <= TRAJ_TOL
    assert rel_err(out["output"]["pred"].numpy(),
                   nchw(jax.device_get(ref["output"]["pred"]))) <= TRAJ_TOL
    by_jax = jax_evaluate_ps(
        {"gt": jnp.asarray(batch["gt"])},
        {"pred": jnp.asarray(out["output"]["pred"].permute(0, 2, 3, 1).numpy())})
    assert_metrics_close(out["metric"].numpy(), jax.device_get(ref["metric"]),
                         np.asarray(by_jax), TRAJ_TOL)


def test_losses_and_metrics_match_jax_at_ties():
    """pred == 0, pred == max_depth, pred == gt and gt == 0 exactly: the
    values, and the gradient of the loss into pred, where both clips split
    a tie's gradient as jnp.clip does."""
    rng = np.random.default_rng(7)
    b, h, w = 2, 6, 9
    pred = rng.uniform(-2.0, 12.0, (b, h, w, 1)).astype(np.float32)
    gt = rng.uniform(0.0, 12.0, (b, h, w, 1)).astype(np.float32)
    pred[:, 0] = 0.0
    pred[:, 1, :3] = 10.0
    gt[:, 2] = 0.0
    gt[:, 3, :4] = pred[:, 3, :4]
    gt[:, 4, :2] = 10.0
    pred[:, 4, :2] = 10.0
    jcfg = JaxConfig(loss="1.0*L1+0.5*L2")
    cfg = Config(**dataclasses.asdict(jcfg))
    jloss, loss = jax_get_loss(jcfg), LossFunction(cfg)

    def jax_total(p):
        return jloss({"gt": jnp.asarray(gt)}, {"pred": p})[0]

    ref_total, ref_grad = jax.value_and_grad(jax_total)(jnp.asarray(pred))
    p = torch.from_numpy(nchw(pred)).requires_grad_(True)
    s = {"gt": torch.from_numpy(nchw(gt))}
    total, vals = loss(s, {"pred": p})
    (grad,) = torch.autograd.grad(total, [p])
    assert total.item() == pytest.approx(float(ref_total), rel=1e-6)
    np.testing.assert_allclose(grad.numpy(), nchw(ref_grad), rtol=1e-5, atol=1e-7)
    assert np.any(nchw(ref_grad) == 0.0)
    ref_vals = jloss({"gt": jnp.asarray(gt)}, {"pred": jnp.asarray(pred)})[1]
    np.testing.assert_allclose(vals.detach().numpy(), ref_vals, rtol=1e-6)
    ps = loss.per_sample(s, {"pred": p.detach()})
    np.testing.assert_allclose(
        ps.numpy(), jloss.per_sample({"gt": jnp.asarray(gt)},
                                     {"pred": jnp.asarray(pred)}), rtol=1e-6)
    np.testing.assert_allclose(ps[:, -1].sum().item(), total.item(), rtol=1e-6)

    jo, js = {"pred": jnp.asarray(pred)}, {"gt": jnp.asarray(gt)}
    o = {"pred": p.detach()}
    np.testing.assert_allclose(evaluate(s, o).numpy(), jax_evaluate(js, jo),
                               rtol=1e-5)
    np.testing.assert_allclose(evaluate_per_sample(s, o).numpy(),
                               jax_evaluate_ps(js, jo), rtol=1e-5)


@pytest.mark.parametrize("opt,wd", [("ADAM", 0.0), ("ADAM", 0.01),
                                    ("SGD", 0.01), ("RMSprop", 0.0)])
def test_optimizers_match_optax(opt, wd):
    """Three updates of each optimizer on the same gradients, warm-up over
    2 steps per epoch and a decay at epoch 2."""
    jcfg = JaxConfig(optimizer=opt, weight_decay=wd, decay="2,3",
                     gamma="1.0,0.5")
    cfg = Config(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]

    tx, jsched = jax_make_optimizer(jcfg, 2)
    params, state = jnp.asarray(p0), None
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer, sched = make_optimizer(cfg, [p], 2)
    for step, g in enumerate(grads):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6)
        set_lr(optimizer, sched(step))
        p.grad = torch.from_numpy(g)
        optimizer.step()
    np.testing.assert_allclose(p.detach().numpy(), params, rtol=1e-5, atol=1e-6)


def test_synthetic_scenes_match_jax():
    kw = dict(patch_height=20, patch_width=28, num_sample=40)
    jcfg = JaxConfig(**kw)
    port, ref = Synthetic(Config(**kw), "val"), JaxSynthetic(jcfg, "val")
    assert len(port) == len(ref)
    a = port.__getitem__(3, np.random.default_rng(1))
    r = ref.__getitem__(3, np.random.default_rng(1))
    for k in ("rgb", "dep", "gt", "K"):
        np.testing.assert_array_equal(a[k], r[k], err_msg=k)
    assert np.count_nonzero(a["dep"]) == 40


def test_train_step_needs_init_state():
    eng = Engine(Config(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="init_state"):
        eng.train_step({})


def test_train_step_leaves_global_cudnn_flags():
    """The step picks cuDNN's benchmark mode for its own calls only."""
    cfg = Config(**TINY, batch_size=1, patch_height=16, patch_width=24)
    eng = Engine(cfg, device="cpu")
    eng.init_state()
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    batch = Synthetic(cfg, "train").batch([0], np.random.default_rng(0))
    aux = eng.train_step(eng.put_batch(batch))
    assert np.isfinite(aux["loss"].item())
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32) == before
