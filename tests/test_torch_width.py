"""The port's width sharding (``num_spatial_shards``, ``parallel/halo.py``)
held against the JAX package's one-device model, on the CPU: gloo ranks in
processes, each holding a strip of the images' columns.

The ranks are spawned once for the module, 2, 3 and 4 of them at once
(``torch_ranks``' ``width`` job; 4 ranks are 2 data shards of 2 strips),
with the CLI under 2 width ranks beside them, and save what they saw; the
JAX references are computed here while they run, and the port's
one-process steps in a process of their own (``one`` job):

* ``halo`` and ``gather_width`` on 2 and 3 strips of a tensor equal its
  slices, and a 3x3 conv (stride 1 and 2) and the k3/s2 transposed conv
  through them give the whole ops' outputs and gradients (f32 sums in
  another order: 1e-5);
* ``Engine.train_step`` of the fork default at 16x48 (``prop_time=2``,
  batch 4) on 2 and 3 strips and on 2 data shards of 2 strips, and at
  16x40 (strips of 24 and 16 columns: ragged) on 2, against the JAX
  package's one-device loss and gradients
  (``jax.value_and_grad`` of its model and loss, as its ``Engine``'s step
  takes them): loss 1e-4, each gradient 5e-3 relative L2 (PARITY.md's
  bars); the ranks end the step with equal bits;
* ``Engine.eval_step``: the gathered ``pred`` within 2e-4 of the JAX eval
  forward, the per-image loss and metric rows within 1e-4 (iRMSE and iMAE,
  which take 1 / pred near the validity floor, against the JAX metrics of
  the port's own ``pred``), rank 0 holding every data shard's rows;
* ``use_GRU=False`` on 2 strips against the port's one-process step, at
  the same bars;
* bf16 on 2 strips: the eval forward at the JAX package's bf16 bar (rtol
  0.1, atol 0.05) against its bf16 model, the train step's loss against
  the port's one-process bf16 step (1e-2) and its gradients no farther from
  the f32 step's than the one-process bf16 step is, twice over
  (``chip_smoke.py``'s phase-15 bars);
* the ragged step in float64 (the model and its casts) on both sides:
  loss and every gradient within 1e-10 of the one-process step;
* the BatchNorm on ragged strips (24 and 16 columns) takes the global
  batch's statistics (the pixel count is all-reduced with the sums);
* a strip without a column is refused; ``python -m
  nlspn_eccv20_tpu_torch.main --num_spatial_shards 2`` trains, validates
  and tests on 2 ranks, rank 0 writing every artifact.

``offset=True`` on strips is ``test_torch_width_offset.py``'s.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.losses import get_loss as jax_get_loss
from nlspn_eccv20_tpu.metrics import evaluate_per_sample as jax_evaluate_ps
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.parallel.mesh import strip_bounds
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables
from test_torch_model import TINY, nchw, random_variables, sample
from test_torch_parallel import _jax_batchnorm
from test_torch_train import (
    LIPSCHITZ_METRICS,
    grads_as_jax_tree,
    norm_rel_err,
    rel_err,
    train_batch,
)
from torch_ranks import Ranks

H, W, W_RAGGED, B = 16, 48, 40, 4
BASE = dict(TINY, prop_time=2, batch_size=B, patch_height=H, patch_width=W,
            platform="cpu")
CASES = {   # name: (config, width, batch, worlds that run it)
    "default": ({}, W, B, (2, 3, 4)),
    "ragged": ({"batch_size": 2, "patch_width": W_RAGGED}, W_RAGGED, 2, (2,)),
    "no_gru": ({"use_GRU": False}, W, B, (2,)),
    "bf16": ({"precision": "bf16"}, W, B, (2,)),
}
EVAL = ("default", "bf16")
JAX_TRAIN = ("default", "ragged")   # no_gru against the port's one-process step
BATCH_SEED = 3       # no ReLU input within the frameworks' BatchNorm noise of 0
LOSS_TOL, GRAD_TOL, FWD_TOL, ROW_TOL = 1e-4, 5e-3, 2e-4, 1e-4
BF16_RTOL, BF16_ATOL = 0.1, 0.05         # tests/test_precision.py's bf16 bar
CLI = ["--platform", "cpu", "--data_name", "Synthetic", "--test_pipeline",
       "--epochs", "1", "--batch_size", "2", "--patch_height", "32",
       "--patch_width", "48", "--prop_time", "2", "--GRU_hidden_dim", "16",
       "--GRU_input_dim", "16", "--num_sample", "50", "--num_threads", "2",
       "--num_spatial_shards", "2", "--save_image", "--save", "width"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads here: the eleven ranks and the suite's other
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_variables(jcfg):
    """Seeded values for every variable of the JAX model (shaped by tracing
    its init, not compiling it)."""
    jmodel = jax_get_model(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, sample(1, H, W), train=False),
                            jax.random.PRNGKey(0))
    return jmodel, random_variables(shapes, seed=1)


def jax_train(jcfg, jmodel, variables, batch):
    """The JAX package's one-device loss, loss terms and gradients of a
    train step on ``batch`` (its ``Engine``'s ``loss_of``)."""
    jloss, n = jax_get_loss(jcfg), batch["rgb"].shape[0]

    def loss_of(params, stats, s):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats},
                              s, train=True, need_inter=False, mutable=["batch_stats"])
        loss_sum, loss_val = jloss(s, out)
        return loss_sum / n, loss_val / n

    (loss, loss_val), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    return jax.device_get((loss, loss_val, grads))


def jax_eval(jcfg, jmodel, variables, batch):
    """The JAX eval forward's pred and pred_init (NCHW), its per-image loss
    and metric rows (in bf16 the JAX model's route on the CPU: its stock
    convs; the bf16 bar holds either route)."""
    jloss = jax_get_loss(jcfg)

    def run(v, s):
        out = jmodel.apply(v, s, train=False)
        return (out["pred"], out["pred_init"], jloss.per_sample(s, out),
                jax_evaluate_ps(s, out))

    pred, pred_init, loss_val, metric = jax.device_get(jax.jit(run)(variables, batch))
    return {"pred": nchw(pred), "pred_init": nchw(pred_init),
            "loss_val": np.asarray(loss_val), "metric": np.asarray(metric)}


def strip_inputs():
    """A (2, 3, 5, 48) tensor, conv and transposed-conv weights, and the
    cotangents of their whole outputs."""
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return {"x": t(2, 3, 5, W), "w1": t(4, 3, 3, 3), "b1": t(4), "wt": t(3, 2, 3, 3),
            "g_s1": t(2, 4, 5, W), "g_s2": t(2, 4, 3, W // 2), "g_t": t(2, 2, 10, 2 * W)}


def bn_inputs():
    rng = np.random.default_rng(60)
    x = (rng.standard_normal((2, 8, 6, W_RAGGED)) * 0.5 + 2.0).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = (rng.standard_normal(8) * 0.1).astype(np.float32)
    return x, g, scale, bias


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case's weights and batch, the ranks' results (2, 3 and 4
    ranks, and the CLI on 2), and the references computed while they run."""
    models, cases, batches = {}, {}, {}
    for name, (kw, width, b, worlds) in CASES.items():
        cfg_kw = {**BASE, **kw}
        jcfg = JaxConfig(**{k: v for k, v in cfg_kw.items() if k != "platform"})
        key = jcfg.use_GRU
        if key not in models:
            models[key] = jax_variables(jcfg)
        jmodel, variables = models[key]
        batches[name] = train_batch(b, H, width, seed=BATCH_SEED)
        cases[name] = {"cfg": cfg_kw, "worlds": worlds, "eval": name in EVAL,
                       "batch": batches[name],
                       "state_dict": from_jax_variables(variables, Config(**cfg_kw))}
    work = tmp_path_factory.mktemp("width")
    x, g, scale, bias = bn_inputs()
    inputs = {**strip_inputs(), "cases": cases, "bn_x": torch.from_numpy(x),
              "bn_g": torch.from_numpy(g), "bn_scale": torch.from_numpy(scale),
              "bn_bias": torch.from_numpy(bias)}
    ranks = {}
    for world in (2, 3, 4):
        (work / str(world)).mkdir()
        torch.save(inputs, work / str(world) / "inputs.pt")
        ranks[world] = Ranks("width", work / str(world), ranks=world)
    one = Ranks("one", work / "2", ranks=1)
    exp = work / "cli" / "exp"
    exp.mkdir(parents=True)
    cli = Ranks("main", work / "cli", CLI + ["--experiments_dir", str(exp)])

    ref = {}
    for name, (kw, width, b, _) in CASES.items():
        cfg_kw = {**BASE, **kw}
        jcfg = JaxConfig(**{k: v for k, v in cfg_kw.items() if k != "platform"})
        jmodel, variables = models[jcfg.use_GRU]
        ref[name] = {"jcfg": jcfg, "variables": variables}
        if name in JAX_TRAIN:
            ref[name]["train"] = jax_train(jcfg, jmodel, variables, batches[name])
        if name in EVAL:
            ref[name]["eval"] = jax_eval(jcfg, jmodel, variables, batches[name])
    one.wait()
    steps = torch.load(work / "2" / "one.pt", weights_only=False)
    ref["bf16"]["one"], ref["no_gru"]["one"] = steps["bf16"], steps["no_gru"]
    ref["float64"] = steps["float64"]
    ref["bn"] = _jax_batchnorm(x, g, scale, bias, jnp.float32)
    got = {}
    for world, r in ranks.items():
        r.wait()
        got[world] = [torch.load(work / str(world) / f"rank{i}.pt", weights_only=False)
                      for i in range(world)]
    outs = cli.wait()
    return {"ranks": got, "ref": ref, "cli": (work / "cli", exp, outs)}


def test_strip_bounds_are_multiples_of_eight():
    assert strip_bounds(1216, 2) == [0, 608, 1216]
    assert strip_bounds(1216, 3) == [0, 408, 808, 1216]
    assert strip_bounds(48, 2) == [0, 24, 48]
    assert strip_bounds(40, 2) == [0, 24, 40]
    with pytest.raises(ValueError, match="strip 1 would hold 0 columns"):
        strip_bounds(16, 4)


@pytest.mark.parametrize("world", [2, 3])
def test_halo_and_gather_are_the_whole_tensors_slices(run, world):
    x = strip_inputs()["x"]
    bounds = strip_bounds(W, world)
    for r, res in enumerate(run["ranks"][world]):
        assert res["strips"] == (r, world)
        a, b = bounds[r], bounds[r + 1]
        assert torch.equal(res["ops"]["halo"], x[..., max(a - 2, 0):min(b + 3, W)])
        assert torch.equal(res["ops"]["whole"], x)


@pytest.mark.parametrize("world", [2, 3])
def test_convs_through_the_halo_are_the_whole_convs(run, world):
    """Outputs and gradients of a 3x3 conv at stride 1 and 2 and of the
    k3/s2/p1/op1 transposed conv on strips, against the whole ops."""
    inp = strip_inputs()
    x, w1, b1, wt = (inp[k].clone().requires_grad_() for k in ("x", "w1", "b1", "wt"))
    ys = {"s1": F.conv2d(x, w1, b1, 1, 1), "s2": F.conv2d(x, w1, b1, 2, 1),
          "t": F.conv_transpose2d(x, wt, None, 2, 1, 1)}
    sum((y * inp["g_" + k]).sum() for k, y in ys.items()).backward()
    bounds = strip_bounds(W, world)
    ranks = run["ranks"][world]
    for k, y in ys.items():
        for res in ranks:
            assert rel_err(res["ops"]["y"][k], y.detach()) <= 1e-5, k
    dx = torch.cat([res["ops"]["dx"] for res in ranks], -1)
    assert [res["ops"]["dx"].shape[-1] for res in ranks] == np.diff(bounds).tolist()
    assert rel_err(dx, x.grad) <= 1e-5
    for res in ranks:
        for k, p in (("dw1", w1), ("db1", b1), ("dwt", wt)):
            assert rel_err(res["ops"][k], p.grad) <= 1e-5, k


def _case(run, world, name):
    return [res["cases"][name] for res in run["ranks"][world]]


def _check_ranks(steps, world, name):
    """Every rank's strip has the columns ``strip_bounds`` gives; the ranks
    end the step with equal bits."""
    space = world if world < 4 else 2
    assert [s["width"] for s in steps[:space]] == np.diff(
        strip_bounds(CASES[name][1], space)).tolist()
    assert (steps[0]["data"], steps[0]["space"]) == (world // space, space)
    for s in steps[1:]:
        for k in steps[0]["after"]:
            assert torch.equal(s["after"][k], steps[0]["after"][k]), k
        assert s["grads"].keys() == steps[0]["grads"].keys()


@pytest.mark.parametrize("world,name", [(2, "default"), (3, "default"), (4, "default"),
                                        (2, "ragged")])
def test_train_step_matches_jax(run, world, name):
    """Loss and every gradient (summed over the ranks) against the JAX
    package's one-device step on the whole batch."""
    ref = run["ref"][name]
    loss, loss_val, grads = ref["train"]
    steps = _case(run, world, name)
    _check_ranks(steps, world, name)
    for s in steps:
        assert rel_err(s["loss"].item(), loss) <= LOSS_TOL
        assert rel_err(s["loss_val"].numpy(), loss_val) <= LOSS_TOL
    model_grads = grads_as_jax_tree(_with_grads(ref, steps[0]), ref["variables"],
                                    ref["jcfg"])["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(grads))
    got = dict(jax.tree_util.tree_leaves_with_path(model_grads))
    assert got.keys() == want.keys()
    worst = max((norm_rel_err(got[k], want[k]), jax.tree_util.keystr(k))
                for k in want if np.any(np.asarray(want[k]) != 0))
    assert worst[0] <= GRAD_TOL, worst


def test_strips_are_the_whole_images_step_in_float64(run):
    """The ragged case (strips of 24 and 16 columns) with the model in
    float64 on both sides: loss and every gradient within 1e-10 of the
    one-process step. In f32 the strips' sums in another order leave 1e-6
    here; at random weights on KITTI-wide images a few gradients lie 1e-2
    from one process's cuDNN step and within 5e-3 of its step through
    PyTorch's own convolutions (``chip_smoke.py`` phase 17 holds each to
    the nearer)."""
    want = run["ref"]["float64"]
    for res in run["ranks"][2]:
        got = res["float64"]
        assert got["loss"].dtype == torch.float64
        assert rel_err(got["loss"].item(), want["loss"].item()) <= 1e-10
        assert got["grads"].keys() == want["grads"].keys()
        for n, g in want["grads"].items():
            if g.abs().max() > 0:
                assert norm_rel_err(got["grads"][n], g) <= 1e-10, n


def test_train_step_without_gru_matches_one_process(run):
    """``use_GRU=False`` (12 K1 steps a forward on the card) on 2 strips:
    loss and every gradient against the port's one-process step, at the
    same bars."""
    loss, grads = run["ref"]["no_gru"]["one"]
    steps = _case(run, 2, "no_gru")
    _check_ranks(steps, 2, "no_gru")
    assert rel_err(steps[0]["loss"].item(), loss) <= LOSS_TOL
    assert steps[0]["grads"].keys() == grads.keys()
    for n, g in grads.items():
        if g.abs().max() > 0:
            assert norm_rel_err(steps[0]["grads"][n], g) <= GRAD_TOL, n


def _with_grads(ref, step):
    """A port model of the case whose ``.grad``s are a rank's summed
    gradients (for ``grads_as_jax_tree``)."""
    from nlspn_eccv20_tpu_torch.models import get_model

    cfg = Config(**dataclasses.asdict(ref["jcfg"]))
    model = get_model(cfg, device="cpu")
    for n, p in model.named_parameters():
        p.grad = step["grads"].get(n)
    return model


@pytest.mark.parametrize("world", [2, 3, 4])
def test_eval_step_matches_jax(run, world):
    """The gathered pred and pred_init of each data shard's images within
    the forward bar of the JAX eval forward, on every rank; rank 0's rows
    are every data shard's, in order."""
    ref = run["ref"]["default"]["eval"]
    steps = _case(run, world, "default")
    space = steps[0]["space"]
    preds = []
    for r, s in enumerate(steps):
        d = r // space
        for k in ("pred", "pred_init"):
            port, want = s["eval"][k].numpy(), ref[k][d * s["rows"]:(d + 1) * s["rows"]]
            assert port.shape == want.shape, k
            assert np.max(np.abs(port - want)) / max(np.max(np.abs(want)), 1.0) <= FWD_TOL
        if r % space == 0:
            preds.append(s["eval"]["pred"].numpy())
    rows = steps[0]["eval"]
    assert rows["metric"].shape == (B, 8)
    assert rel_err(rows["loss_val"].numpy(), ref["loss_val"]) <= ROW_TOL
    assert rel_err(rows["metric"].numpy()[:, LIPSCHITZ_METRICS],
                   ref["metric"][:, LIPSCHITZ_METRICS]) <= ROW_TOL
    by_jax = np.asarray(jax_evaluate_ps(
        {"gt": jnp.asarray(train_batch(B, H, W, seed=BATCH_SEED)["gt"])},
        {"pred": jnp.asarray(np.transpose(np.concatenate(preds), (0, 2, 3, 1)))}))
    np.testing.assert_allclose(rows["metric"].numpy(), by_jax, rtol=ROW_TOL)


def test_bf16_matches_the_jax_bf16_model_and_the_one_process_step(run):
    """The bf16 eval forward on 2 strips at the JAX package's bf16 bar; the
    bf16 train step: loss within 1e-2 of the port's one-process bf16 step,
    and each gradient no farther from the one-process f32 step's than
    min(max(5e-2, 2 x the one-process bf16 step's distance), 0.5) relative
    L2, its norm 3/4 to 4/3 of the f32 one's (bf16 flips ReLU masks, so two
    bf16 runs lie about twice as far apart as either from f32)."""
    ref = run["ref"]["bf16"]
    steps = _case(run, 2, "bf16")
    for s in steps:
        for k in ("pred", "pred_init"):
            np.testing.assert_allclose(s["eval"][k].numpy(), ref["eval"][k],
                                       rtol=BF16_RTOL, atol=BF16_ATOL)
    (_, f32), (loss, bf16) = ref["one"]["f32"], ref["one"]["bf16"]
    assert rel_err(steps[0]["loss"].item(), loss) <= 1e-2
    assert steps[0]["grads"].keys() == f32.keys()
    for n, g in f32.items():
        if g.abs().max() == 0:
            continue
        bar = min(max(5e-2, 2 * norm_rel_err(bf16[n], g)), 0.5)
        got = steps[0]["grads"][n]
        assert norm_rel_err(got, g) <= bar, n
        assert 3 / 4 <= (got.norm() / g.norm()).item() <= 4 / 3, n
    for k in steps[0]["after"]:
        assert torch.equal(steps[1]["after"][k], steps[0]["after"][k]), k


def test_batchnorm_on_ragged_strips_takes_the_global_batch(run):
    """Strips of 24 and 16 columns: output, running statistics, input and
    parameter gradients of the whole batch's BatchNorm (JAX's)."""
    y, stats, dx, dp = run["ref"]["bn"]
    got = [res["batchnorm"] for res in run["ranks"][2]]
    assert [g["y"].shape[-1] for g in got] == [24, 16]
    assert rel_err(torch.cat([g["y"] for g in got], -1).numpy(), y) <= 2e-4
    assert rel_err(torch.cat([g["dx"] for g in got], -1).numpy(), dx) <= 1e-5
    for g in got:
        assert rel_err(g["mean"].numpy(), stats["mean"]) <= 1e-5
        assert rel_err(g["var"].numpy(), stats["var"]) <= 1e-5
        assert rel_err(g["dscale"].numpy(), dp["scale"]) <= 1e-5
        assert rel_err(g["dbias"].numpy(), dp["bias"]) <= 1e-5


@pytest.mark.parametrize("name,want", [
    ("no_column", "8 columns over num_spatial_shards=2: strip 1 would hold 0 columns"),
])
def test_width_shards_refuse(run, name, want):
    for res in run["ranks"][2]:
        got = res["refusals"][name]
        assert got is not None and got.startswith(want), got


def test_ranks_ran_gloo_on_the_cpu(run):
    for world, ranks in run["ranks"].items():
        assert [(r["world"], r["backend"]) for r in ranks] == [(world, "gloo")] * world


def test_cli_trains_and_tests_on_two_strips(run):
    """``main --num_spatial_shards 2`` on 2 ranks: one data shard of 2
    images, every artifact from rank 0 (the test images whole), none from
    rank 1."""
    work, exp, outs = run["cli"]
    assert "data parallel: 2 ranks, 2 strips an image" in outs[0]
    assert "train epoch 1: 2 images in" in outs[0]
    assert "test epoch 0000 | Metric" in outs[0]
    (name,) = os.listdir(exp)
    for f in ("args.json", "metric_val.txt", "metric_test.txt",
              os.path.join("ckpt", "model_00001.pt")):
        assert (exp / name / f).exists(), f
    affs = [os.path.join(d, f) for d, _, fs in os.walk(exp / name) for f in fs
            if f == "aff.npy"]
    assert affs and all(np.load(a).shape[2] == 48 for a in affs)   # NHWC, whole
    with open(work / "writes1.txt") as f:
        assert f.read() == ""
