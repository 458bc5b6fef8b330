"""The port's ``--offset`` model on width strips (``num_spatial_shards``)
held against the JAX package's one-device model, on the CPU: gloo ranks in
processes, each holding a strip of the images' columns.

Under width shards the JAX package runs this configuration through XLA's
gather, its exchanges placed by the SPMD partitioner; its own test only
lowers it. The port runs K7 and K8 on each rank's strip extended by a halo
of real columns (``models/nlspn.NLSPNModel._offset_span``): in training the
windowed backward's reach ``prop_kernel // 2 + R + 1``, for the exact
gather (eval, and training at ``offset_window=0``) ``prop_kernel // 2 +
ceil(max |dx|) + 1`` over the strips, or the whole width where that passes
the narrowest strip. The one-device model computes the same function, so
the ranks are held to it.

The setup is the fork default with ``offset=True, offset_window=2,
offset_neighbor_loop='scan'`` at 16x48, ``prop_time=2``, batch 4, the JAX
variables seeded and carried over, the offset head's channels scaled
(``with_offset_scale``) so that the offsets stay inside the window
(``INSIDE``), escape it (``ESCAPE``: the clamp cuts them in training, the
exact gather reaches 9 columns in eval), reach past a 16-column strip
(``WHOLE``: eval on 3 strips takes the whole width) or past a 24-column one
in training at ``offset_window=0`` (``FAR``). The ranks are spawned once
for the module, 2, 3 and 4 of them (2 data shards of 2 strips) and the CLI
on 2, while the JAX references compile here (one jitted function a
configuration, the variables its arguments):

* the f32 train step on 2 and 3 strips and on 2 x 2, escaping the window:
  loss 1e-4 and each gradient 5e-3 relative L2 of the JAX
  ``jax.value_and_grad`` (PARITY.md's bars), off_max 1e-5, the ranks'
  weights equal bits after it; at ``offset_window=0`` on 2 strips the same;
* the f32 eval forward on 2, 3 and 2 x 2 strips, inside the window and
  escaping it, and on 3 strips past it: the gathered pred, pred_init and
  offsets within 2e-4 of the JAX eval forward, the route the rank took
  (``offset_route``) the one its offsets ask for;
* float64 on 2 strips, the halo route (window 2) and the whole-width route
  (window 0, ``FAR``): loss and every gradient within 1e-10 of the port's
  one-process step;
* bf16 on 2 strips at ``test_torch_width.py``'s bars;
* ``main --offset --num_spatial_shards 2`` on 2 ranks trains, validates and
  tests, rank 0 writing every artifact, the offsets it writes whole-width.
"""

import math
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.losses import get_loss as jax_get_loss
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.parallel.mesh import strip_bounds
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables
from test_torch_model import TINY, nchw
from test_torch_offset_model import with_offset_scale
from test_torch_train import grads_as_jax_tree, norm_rel_err, rel_err, train_batch
from test_torch_width import (
    BATCH_SEED,
    BF16_ATOL,
    BF16_RTOL,
    CLI,
    FWD_TOL,
    GRAD_TOL,
    LOSS_TOL,
    _with_grads,
    few_threads,   # noqa: F401  (the module's two intra-op threads)
    jax_variables,
)
from torch_ranks import Ranks

H, W, B = 16, 48, 4
BASE = dict(TINY, prop_time=2, batch_size=B, patch_height=H, patch_width=W,
            platform="cpu", offset=True, offset_window=2, offset_neighbor_loop="scan")
# the offset head's scales; at 1 max |offset| is 2.35 in eval and 2.95 in
# training on this batch
INSIDE, ESCAPE, WHOLE, FAR = 0.5, 3.0, 8.0, 10.0
EDGE = "edge"   # every offset at the window's edge (with_offsets_at_the_window_edge)
CASES = {   # name: (config, offset scale, eval, train, worlds that run it)
    "escape": ({}, ESCAPE, True, True, (2, 3, 4)),
    "inside": ({}, INSIDE, True, False, (2, 3)),
    "whole": ({}, WHOLE, True, False, (3,)),
    "window0": ({"offset_window": 0}, ESCAPE, False, True, (2,)),
    "bf16": ({"precision": "bf16"}, ESCAPE, True, True, (2,)),
    "edge": ({}, EDGE, False, True, (2,)),
}
FLOAT64 = {   # name: (config, offset scale, the route of its train step)
    "halo": ({}, ESCAPE, "halo"),
    "edge": ({}, EDGE, "halo"),
    "whole": ({"offset_window": 0}, FAR, "whole"),
}
KC = Config().prop_kernel // 2   # the step's half width


def with_offsets_at_the_window_edge(variables, jcfg):
    """The variables with every offset exactly at the window's edge: the
    offset channels' kernel zero, their bias dy = 0.5, dx = +R for even
    neighbours and -R for odd ones. The clamp passes half their gradient
    there, and the windowed backward reads the tap past the ceil corner,
    R + 1 beyond the kernel shift: the halo's last column."""
    n, r = jcfg.num_neighbors, float(jcfg.offset_window)
    heads = dict(variables["params"]["heads"])
    kernel = np.array(heads["off_aff_dec0_kernel"])
    bias = np.array(heads["off_aff_dec0_bias"])
    kernel[..., :2 * n] = 0.0
    bias[0:2 * n:2] = 0.5
    bias[1:2 * n:2] = np.where(np.arange(n) % 2 == 0, r, -r)
    heads.update(off_aff_dec0_kernel=kernel, off_aff_dec0_bias=bias)
    return {"params": dict(variables["params"], heads=heads),
            "batch_stats": variables["batch_stats"]}


def _cfg(kw):
    return {**BASE, **kw}


def _jcfg(kw):
    return JaxConfig(**{k: v for k, v in _cfg(kw).items() if k != "platform"})


def _scaled(variables, jcfg, scale):
    if scale == EDGE:
        return with_offsets_at_the_window_edge(variables, jcfg)
    return with_offset_scale(variables, jcfg, scale)


def _state(variables, jcfg, kw, scale):
    return from_jax_variables(_scaled(variables, jcfg, scale), Config(**_cfg(kw)))


def jax_train_fn(jcfg):
    """The JAX one-device loss, loss terms, gradients and max |offset| of a
    train step, jitted once with the variables as arguments."""
    jmodel, jloss = jax_get_model(jcfg), jax_get_loss(jcfg)

    def loss_of(params, stats, s):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats},
                              s, train=True, need_inter=False, mutable=["batch_stats"])
        loss_sum, loss_val = jloss(s, out)
        n = s["rgb"].shape[0]
        return loss_sum / n, (loss_val / n, jnp.max(jnp.abs(out["offset"])))

    step = jax.jit(jax.value_and_grad(loss_of, has_aux=True))

    def run(variables, batch):
        (loss, (loss_val, off_max)), grads = step(variables["params"],
                                                  variables["batch_stats"], batch)
        return jax.device_get((loss, loss_val, off_max, grads))

    return run


def jax_eval_fn(jcfg):
    """The JAX eval forward's pred, pred_init and offsets (NCHW), jitted
    once with the variables as arguments."""
    jmodel = jax_get_model(jcfg)
    fwd = jax.jit(lambda v, s: {k: jmodel.apply(v, s, train=False)[k]
                                for k in ("pred", "pred_init", "offset")})
    return lambda variables, batch: {k: nchw(v) for k, v in
                                     jax.device_get(fwd(variables, batch)).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results (2, 3 and 4 ranks, the CLI on 2, the one-process
    steps) and the JAX references computed while they run."""
    jcfg = _jcfg({})
    _, variables = jax_variables(jcfg)
    batch = train_batch(B, H, W, seed=BATCH_SEED)
    inputs = {"cases": {}, "float64": {}}
    for name, (kw, scale, ev, tr, worlds) in CASES.items():
        inputs["cases"][name] = {"cfg": _cfg(kw), "worlds": worlds, "eval": ev, "train": tr,
                                 "batch": batch,
                                 "state_dict": _state(variables, jcfg, kw, scale)}
    for name, (kw, scale, _) in FLOAT64.items():
        inputs["float64"][name] = {"cfg": _cfg(kw), "batch": batch,
                                   "state_dict": _state(variables, jcfg, kw, scale)}
    work = tmp_path_factory.mktemp("width_offset")
    ranks = {}
    for world in (2, 3, 4):
        (work / str(world)).mkdir()
        torch.save(inputs, work / str(world) / "inputs.pt")
        ranks[world] = Ranks("width_offset", work / str(world), ranks=world)
    one = Ranks("offset_one", work / "2", ranks=1)
    exp = work / "cli" / "exp"
    exp.mkdir(parents=True)
    cli = Ranks("main", work / "cli", CLI + ["--offset", "--experiments_dir", str(exp)])

    scaled = {s: _scaled(variables, jcfg, s) for s in (INSIDE, ESCAPE, WHOLE, EDGE)}

    def evals():
        ev = jax_eval_fn(jcfg)
        return {s: ev(scaled[s], batch) for s in (INSIDE, ESCAPE, WHOLE)}

    def trains():
        step = jax_train_fn(jcfg)
        return {s: step(scaled[s], batch) for s in (ESCAPE, EDGE)}

    # the four compiles at once: XLA's compiler runs outside the GIL
    with ThreadPoolExecutor(4) as pool:
        jobs = {"eval": pool.submit(evals),
                "train": pool.submit(trains),
                "window0": pool.submit(lambda: jax_train_fn(_jcfg({"offset_window": 0}))(
                    scaled[ESCAPE], batch)),
                "bf16_eval": pool.submit(lambda: jax_eval_fn(_jcfg({"precision": "bf16"}))(
                    scaled[ESCAPE], batch))}
        ref = {k: f.result() for k, f in jobs.items()}
    ref.update(variables=variables, jcfg=jcfg)
    one.wait()
    ref["one"] = torch.load(work / "2" / "one.pt", weights_only=False)
    got = {}
    for world, r in ranks.items():
        r.wait()
        got[world] = [torch.load(work / str(world) / f"rank{i}.pt", weights_only=False)
                      for i in range(world)]
    outs = cli.wait()
    return {"ranks": got, "ref": ref, "cli": (work / "cli", exp, outs)}


def _case(run, world, name):
    return [res["cases"][name] for res in run["ranks"][world]]


def _reach(off):
    """The exact gather's reach for offsets ``off`` (NCHW): the kernel's
    half width, the farthest dx's ceil, and one column for the slope."""
    return KC + math.ceil(float(np.max(np.abs(off[:, 1::2])))) + 1


def _check_train(steps, world, want, jcfg, variables, route):
    """Loss, loss terms, off_max and every gradient (summed over the
    ranks) against the JAX one-device step; the strips' widths, the route
    and equal bits on every rank after the step."""
    loss, loss_val, off_max, grads = want
    space = world if world < 4 else 2
    assert [s["width"] for s in steps[:space]] == np.diff(strip_bounds(W, space)).tolist()
    assert (steps[0]["data"], steps[0]["space"]) == (world // space, space)
    for s in steps:
        assert s["route"] == route
        assert rel_err(s["loss"].item(), loss) <= LOSS_TOL
        assert rel_err(s["loss_val"].numpy(), loss_val) <= LOSS_TOL
        assert rel_err(s["off_max"].item(), off_max) <= 1e-5
        for k in steps[0]["after"]:
            assert torch.equal(s["after"][k], steps[0]["after"][k]), k
    model_grads = grads_as_jax_tree(_with_grads({"jcfg": jcfg}, steps[0]),
                                    variables, jcfg)["params"]
    want_g = dict(jax.tree_util.tree_leaves_with_path(grads))
    got_g = dict(jax.tree_util.tree_leaves_with_path(model_grads))
    assert got_g.keys() == want_g.keys()
    worst = max((norm_rel_err(got_g[k], want_g[k]), jax.tree_util.keystr(k))
                for k in want_g if np.any(np.asarray(want_g[k]) != 0))
    assert worst[0] <= GRAD_TOL, worst
    off_grad = grads["heads"]["off_aff_dec0_kernel"][..., :2 * jcfg.num_neighbors]
    assert np.any(np.asarray(off_grad) != 0.0)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_train_step_matches_jax(run, world):
    """Offsets escaping the window (the clamp cuts their gradient beyond
    it and halves it at its edge), on 2 and 3 strips and 2 x 2: the halo of
    the windowed backward's reach, kernel // 2 + R + 1 = 4 columns."""
    ref = run["ref"]
    assert ref["train"][ESCAPE][2] > BASE["offset_window"]
    _check_train(_case(run, world, "escape"), world, ref["train"][ESCAPE], ref["jcfg"],
                 ref["variables"], ("halo", KC + BASE["offset_window"] + 1))


def test_train_step_at_the_window_edge_matches_jax(run):
    """Every offset exactly at +-R on 2 strips: the clamp passes half their
    gradient, and its slope reads the tap R + 1 past the kernel shift,
    the last column of the halo."""
    ref = run["ref"]
    assert ref["train"][EDGE][2] == BASE["offset_window"]
    _check_train(_case(run, 2, "edge"), 2, ref["train"][EDGE], ref["jcfg"],
                 ref["variables"], ("halo", KC + BASE["offset_window"] + 1))


def test_window_0_train_step_matches_jax(run):
    """``offset_window=0``: the exact gather, unclamped, and its VJP, on 2
    strips; the halo is the offsets' own reach."""
    ref = run["ref"]
    want = ref["window0"]
    steps = _case(run, 2, "window0")
    jcfg = _jcfg({"offset_window": 0})
    reach = KC + math.ceil(float(want[2])) + 1
    assert reach <= W // 2
    _check_train(steps, 2, want, jcfg, ref["variables"], ("halo", reach))


@pytest.mark.parametrize("world,name", [
    (2, "inside"), (2, "escape"), (3, "inside"), (3, "escape"), (3, "whole"), (4, "escape"),
])
def test_eval_forward_matches_jax(run, world, name):
    """The gathered pred, pred_init and offsets of each data shard's images
    within 2e-4 of the JAX eval forward (its windowed branch inside the
    window, its exact gather beyond), on every rank; the route is the halo
    of the shard's reach where it fits the narrowest strip, else the whole
    width."""
    scale = CASES[name][1]
    ref = run["ref"]["eval"][scale]
    off_max = float(np.max(np.abs(ref["offset"])))
    assert (off_max > BASE["offset_window"]) == (name != "inside"), off_max
    steps = _case(run, world, name)
    space = steps[0]["space"]
    narrowest = min(np.diff(strip_bounds(W, space)))
    for s in steps:
        rows = slice(s["shard"] * s["rows"], (s["shard"] + 1) * s["rows"])
        reach = _reach(ref["offset"][rows])
        want_route = ("halo" if reach <= narrowest else "whole", reach)
        assert s["eval"]["route"] == want_route
        for k in ("pred", "pred_init", "offset"):
            port, want = s["eval"][k].numpy(), ref[k][rows]
            assert port.shape == want.shape, k
            assert np.max(np.abs(port - want)) / max(np.max(np.abs(want)), 1.0) <= FWD_TOL, k
    if name == "whole":
        assert steps[0]["eval"]["route"][0] == "whole"


@pytest.mark.parametrize("name", sorted(FLOAT64))
def test_strips_are_the_whole_images_step_in_float64(run, name):
    """The model in float64 on both sides, on 2 strips: the halo route
    (window 2; escaping the window, and every offset at its edge) and the
    whole-width one (window 0, offsets reaching past a strip): loss and
    every gradient within 1e-10 of the one-process step."""
    want = run["ref"]["one"]["float64"][name]
    assert want["route"] is None
    for res in run["ranks"][2]:
        got = res["float64"][name]
        assert got["loss"].dtype == torch.float64
        assert got["route"][0] == FLOAT64[name][2]
        assert rel_err(got["loss"].item(), want["loss"].item()) <= 1e-10
        assert got["grads"].keys() == want["grads"].keys()
        for n, g in want["grads"].items():
            if g.abs().max() > 0:
                assert norm_rel_err(got["grads"][n], g) <= 1e-10, n


def test_bf16_matches_the_jax_bf16_model_and_the_one_process_step(run):
    """bf16 on 2 strips at ``test_torch_width.py``'s bars: the eval forward
    at the JAX package's bf16 bar (rtol 0.1, atol 0.05); the train step's
    loss within 1e-2 of the port's one-process bf16 step, each gradient no
    farther from the one-process f32 step's than min(max(5e-2, 2 x the
    one-process bf16 step's distance), 0.5) relative L2, its norm 3/4 to
    4/3 of the f32 one's; equal bits on both ranks after the step."""
    ref = run["ref"]
    steps = _case(run, 2, "bf16")
    for s in steps:
        assert s["eval"]["route"][0] == "halo"
        for k in ("pred", "pred_init"):
            np.testing.assert_allclose(s["eval"][k].numpy(), ref["bf16_eval"][k],
                                       rtol=BF16_RTOL, atol=BF16_ATOL)
    (_, f32), (loss, bf16) = ref["one"]["bf16"]["f32"], ref["one"]["bf16"]["bf16"]
    t = steps[0]
    assert rel_err(t["loss"].item(), loss) <= 1e-2
    assert t["grads"].keys() == f32.keys()
    for n, g in f32.items():
        if g.abs().max() == 0:
            continue
        bar = min(max(5e-2, 2 * norm_rel_err(bf16[n], g)), 0.5)
        assert norm_rel_err(t["grads"][n], g) <= bar, n
        assert 3 / 4 <= (t["grads"][n].norm() / g.norm()).item() <= 4 / 3, n
    for k in t["after"]:
        assert torch.equal(steps[1]["after"][k], t["after"][k]), k


def test_ranks_ran_gloo_on_the_cpu(run):
    for world, ranks in run["ranks"].items():
        assert [(r["world"], r["backend"]) for r in ranks] == [(world, "gloo")] * world


def test_cli_trains_and_tests_offset_on_two_strips(run):
    """``main --offset --num_spatial_shards 2`` on 2 ranks: every artifact
    from rank 0, none from rank 1; the test images' offsets it writes are
    whole-width (NHWC, 2 K2 channels)."""
    work, exp, outs = run["cli"]
    assert "data parallel: 2 ranks, 2 strips an image" in outs[0]
    assert "train epoch 1: 2 images in" in outs[0] and "max|offset|" in outs[0]
    assert "test epoch 0000 | Metric" in outs[0]
    (name,) = os.listdir(exp)
    for f in ("args.json", "metric_val.txt", "metric_test.txt",
              os.path.join("ckpt", "model_00001.pt")):
        assert (exp / name / f).exists(), f
    offs = [os.path.join(d, f) for d, _, fs in os.walk(exp / name) for f in fs
            if f == "offset.npy"]
    assert offs and all(np.load(o).shape[1:] == (32, 48, 18) for o in offs)
    with open(work / "writes1.txt") as f:
        assert f.read() == ""
