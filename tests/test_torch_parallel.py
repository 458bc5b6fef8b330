"""The port's data parallel (``parallel/mesh.py``) held against the JAX
package's data mesh, on the CPU: two ranks in two processes, gloo.

The ranks are spawned once for the module (``torch_ranks.spawn``, a time
limit each) and save what they saw; the tests hold it against the JAX
package run here on the conftest's 8 virtual devices:

* the synchronised ``BatchNorm``, each rank given half a batch, against
  the JAX ``BatchNorm`` on the whole batch (the global batch's statistics):
  output, running statistics, input and parameter gradients; f32 at the
  forward bar 2e-4 (gradients and statistics 1e-5 of max |ref|), bf16 at
  the JAX package's bf16 bars (``test_torch_bf16_train.py``: output and dx
  one bf16 ulp, the rest 1e-5);
* ``Engine.train_step`` at a global batch of 4, two images a rank, against
  the JAX ``Engine`` on a 2-device data mesh from the same weights: loss
  1e-4, parameters after the step 5e-3 (relative L2) and BatchNorm
  statistics 2e-4 of max |ref|; each gradient summed over the ranks within 5e-3 (relative L2) of
  the port's one-process step (PARITY.md's bars); the two ranks end the
  step with equal bits, rank 1 having started from other weights
  (``init_state`` broadcasts rank 0's);
* the test loop over a split of 7 samples counts each sample once, rows in
  the split's order, and summarises as one process does;
* ``main`` refuses, on every rank and before any data is read, a batch
  that does not divide over the ranks, width shards that do not divide the
  ranks (the JAX ``make_mesh``'s words) and a data-shard count other than
  the ranks';
* without a launcher's variables nothing is initialised, as
  ``tests/test_multiprocess.py`` pins for the JAX package.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.models.common import BatchNorm as JaxBatchNorm
from nlspn_eccv20_tpu.parallel import replicate as jax_replicate
from nlspn_eccv20_tpu.train import Engine as JaxEngine
from nlspn_eccv20_tpu.utils.torch_import import import_nlspn_state_dict
from nlspn_eccv20_tpu_torch import main as pmain
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic
from nlspn_eccv20_tpu_torch.parallel import mesh
from nlspn_eccv20_tpu_torch.summary import Summary
from nlspn_eccv20_tpu_torch.train import Engine
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables
from test_torch_model import TINY, nchw, random_variables
from test_torch_train import norm_rel_err, rel_err, train_batch
from torch_ranks import Ranks

H, W, GBATCH, TEST_LEN = 32, 48, 4, 7
ULP = 2.0 ** -7
CFG = dict(TINY, batch_size=GBATCH, patch_height=H, patch_width=W, num_sample=60,
           data_name="Synthetic", platform="cpu", num_data_shards=2)
# parameters without a gradient (aff_scale_const is frozen unless TGASS)
# and the offset heads: every rank must sum the same set
OTHER = dict(CFG, affinity="TC", offset=True, offset_window=1)
REFUSE = {"batch": ({"batch_size": 3}, "batch_size=3 does not divide over the 2 ranks"),
          "width": ({"num_spatial_shards": 4},
                    "2 devices not divisible by num_spatial_shards=4"),
          "data": ({"num_data_shards": 3}, "num_data_shards=3 with 2 ranks")}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads here: the two ranks and the suite's other
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bn_inputs():
    rng = np.random.default_rng(60)
    x = (rng.standard_normal((4, 8, 6, 10)) * 0.5 + 2.0).astype(np.float32)   # NCHW
    g = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = (rng.standard_normal(8) * 0.1).astype(np.float32)
    return x, g, scale, bias


@pytest.fixture(scope="module")
def run(bn_inputs, tmp_path_factory):
    """Seeded variables of the JAX model and a batch; the two ranks' results
    of the ``parallel`` job on them, the JAX Engine's train step on a
    2-device data mesh and the port's one-process step (no process group),
    the last two computed while the ranks run."""
    jcfg = JaxConfig(**{k: v for k, v in CFG.items() if k != "platform"})
    jeng = JaxEngine(jcfg, steps_per_epoch=1)
    assert jeng.mesh.shape["data"] == 2
    state = jax.device_get(jeng.init_state((H, W)))
    variables = random_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, seed=5)
    batch = train_batch(GBATCH, H, W, seed=4)
    cfg = Config(**CFG)
    state_dict = from_jax_variables(variables, cfg)
    other = Engine(Config(**OTHER), device="cpu")
    other_sd = {k: v.clone() for k, v in other.model.state_dict().items()}
    x, g, scale, bias = bn_inputs
    work = tmp_path_factory.mktemp("ranks")
    as_t = torch.from_numpy
    torch.save({"bn_x": as_t(x), "bn_g": as_t(g), "bn_scale": as_t(scale),
                "bn_bias": as_t(bias), "cfg": CFG, "test_len": TEST_LEN,
                "state_dict": state_dict, "batch": {k: as_t(v) for k, v in batch.items()},
                "other_cfg": OTHER, "other_state_dict": other_sd,
                "refuse": {k: kw for k, (kw, _) in REFUSE.items()}},
               work / "inputs.pt")
    ranks = Ranks("parallel", work)

    state = jax_replicate(jeng.mesh, state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jeng.tx.init(variables["params"])))
    new_state, aux = jeng.train_step_fn()(state, jeng.put_train_batch(batch))
    eng = Engine(cfg, steps_per_epoch=1, device="cpu")
    model = eng.init_state(state_dict)
    one_loss = eng.train_step(eng.put_train_batch(batch))["loss"].item()
    one_grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
    other.init_state(other_sd)
    other.train_step(other.put_train_batch(batch))
    other_grads = {n: p.grad.clone() for n, p in other.model.named_parameters()
                   if p.grad is not None}
    one_test = _one_process_test_loop(state_dict, work / "one")
    ranks.wait()
    return {"ranks": [torch.load(work / f"rank{r}.pt", weights_only=False)
                      for r in range(2)],
            "jax": (jcfg, variables, jax.device_get(new_state), jax.device_get(aux)),
            "one": (one_loss, one_grads), "one_test": one_test, "other": other_grads}


def _one_process_test_loop(state_dict, save_dir):
    """``main.test`` in this process over the test split cut to 7 samples:
    its summary and the metric rows its writer received."""
    rows, add, sizes = [], Summary.add, Synthetic.SPLIT_SIZES
    tb = sys.modules.get("torch.utils.tensorboard", False)

    def recording_add(self, loss=None, metric=None):
        rows.append(np.asarray(metric))
        add(self, loss, metric)

    Summary.add = recording_add
    Synthetic.SPLIT_SIZES = dict(sizes, test=TEST_LEN)
    sys.modules["torch.utils.tensorboard"] = None   # its import outlasts the loop
    try:
        cfg = Config(**CFG, save_dir=str(save_dir)).finalize()
        eng = Engine(cfg, device="cpu")
        eng.init_state(state_dict)
        return pmain.test(cfg, eng), np.concatenate(rows)
    finally:
        Summary.add, Synthetic.SPLIT_SIZES = add, sizes
        if tb is False:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tb


@pytest.fixture(scope="module")
def ranks(run):
    return run["ranks"]


def _jax_batchnorm(x, g, scale, bias, dtype):
    """The JAX BatchNorm in train mode on the whole NHWC batch: output,
    new running statistics, and the VJP of the cotangent g."""
    jbn = JaxBatchNorm(use_running_average=False, dtype=dtype)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    c = x.shape[1]
    stats0 = {"BatchNorm_0": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    xh = jnp.asarray(np.transpose(x, (0, 2, 3, 1)), dtype)
    (y, mut), vjp = jax.vjp(lambda xx, p: jbn.apply(
        {"params": p, "batch_stats": stats0}, xx, mutable=["batch_stats"]), xh, params)
    gh = jnp.asarray(np.transpose(g, (0, 2, 3, 1)), dtype)
    dx, dp = vjp((gh, jax.tree_util.tree_map(jnp.zeros_like, mut)))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))   # noqa: E731
    return (nchw(f32(y)), mut["batch_stats"]["BatchNorm_0"], nchw(f32(dx)),
            dp["BatchNorm_0"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_takes_the_global_batch(ranks, bn_inputs, dtype):
    x, g, scale, bias = bn_inputs
    if dtype == "bfloat16":   # inputs as bf16 values on both sides
        x, g = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, g))
    y, stats, dx, dp = _jax_batchnorm(x, g, scale, bias, getattr(jnp, dtype))
    got = [r["batchnorm"][dtype] for r in ranks]
    assert all(r["y_dtype"] == r["dx_dtype"] == f"torch.{dtype}" for r in got)
    port_y = torch.cat([r["y"] for r in got]).float().numpy()
    port_dx = torch.cat([r["dx"] for r in got]).float().numpy()
    fwd_tol, dx_tol = (2e-4, 1e-5) if dtype == "float32" else (ULP, ULP)
    assert rel_err(port_y, y) <= fwd_tol
    assert rel_err(port_dx, dx) <= dx_tol
    for r in got:
        assert rel_err(r["mean"].numpy(), stats["mean"]) <= 1e-5
        assert rel_err(r["var"].numpy(), stats["var"]) <= 1e-5
        assert rel_err(r["dscale"].numpy(), dp["scale"]) <= 1e-5
        assert rel_err(r["dbias"].numpy(), dp["bias"]) <= 1e-5
    for k in ("mean", "var", "dscale", "dbias"):
        assert torch.equal(got[0][k], got[1][k]), k


def test_train_step_matches_the_jax_data_mesh(run):
    """Loss, parameters and BatchNorm statistics against the JAX step on
    its data mesh; the gradients (summed over the ranks) against the
    port's one-process step. The frameworks' gradients lie up to 8e-3
    apart at these weights in one process too: their BatchNorm noise flips
    ReLU masks (``tests/test_torch_train.py`` says how); the ranks move
    them by f32 sum order only. Parameters are held by relative L2: Adam's
    first step moves each weight by about lr * sign(grad), so a gradient
    near zero flips a single entry by 2 lr (one process against JAX reads
    2.6e-2 of max |w| and 2.1e-3 relative L2 at these weights)."""
    jcfg, variables, new_state, aux = run["jax"]
    one_loss, one_grads = run["one"]
    for r in run["ranks"]:
        step = r["train_step"]
        assert step["batch_rows"] == GBATCH // 2
        assert rel_err(step["loss"].item(), aux["loss"]) <= 1e-4
        assert rel_err(step["loss"].item(), one_loss) <= 1e-4
        assert rel_err(step["loss_val"].numpy(), aux["loss_val"]) <= 1e-4
        assert step["grads"].keys() == one_grads.keys()
        for n, g in one_grads.items():
            assert norm_rel_err(step["grads"][n], g) <= 5e-3, n
        after = import_nlspn_state_dict(variables, step["after"], jcfg)
        for part, err, tol in (("params", norm_rel_err, 5e-3),
                               ("batch_stats", rel_err, 2e-4)):
            want = dict(jax.tree_util.tree_leaves_with_path(getattr(new_state, part)))
            for path, port in jax.tree_util.tree_leaves_with_path(after[part]):
                assert err(port, want[path]) <= tol, jax.tree_util.keystr(path)


def test_frozen_and_offset_parameters_sum_alike(run):
    """``affinity='TC'`` with offsets: ``aff_scale_const`` has no gradient
    on any rank, the offset heads have theirs, and the summed gradients
    are the one-process step's; the ranks end with equal bits."""
    a, b = (r["train_step_other"] for r in run["ranks"])
    one = run["other"]
    assert a["grads"].keys() == b["grads"].keys() == one.keys()
    assert "aff_scale_const" not in one
    assert any(n.startswith("off_aff_dec") for n in one)
    for n, g in one.items():
        assert norm_rel_err(a["grads"][n], g) <= 5e-3, n
    for k in a["after"]:
        assert torch.equal(a["after"][k], b["after"][k]), k


def test_ranks_end_the_step_with_equal_bits(ranks):
    a, b = (r["train_step"] for r in ranks)
    for k in a["start"]:
        assert torch.equal(a["start"][k], b["start"][k]), k   # rank 0's weights
        assert torch.equal(a["after"][k], b["after"][k]), k
    for k in ("loss", "loss_val", "metric"):
        assert torch.equal(a[k], b[k]), k
    assert a["grads"].keys() == b["grads"].keys()
    assert "aff_scale_const" in a["grads"]   # TGASS: it trains


def test_test_loop_counts_each_sample_once(run):
    """7 samples over 2 ranks: rank 1's fourth is the shards' padding. Rank
    0 receives 7 rows, each the one-process run's row for that sample in
    the split's order, and writes the same summary."""
    ranks = run["ranks"]
    rows = ranks[0]["test_loop"]["rows"]
    assert ranks[1]["test_loop"]["rows"] is None and ranks[1]["test_loop"]["summary"] == {}
    one, one_rows = run["one_test"]
    assert rows.shape == one_rows.shape == (TEST_LEN, 8)
    np.testing.assert_allclose(rows, one_rows, rtol=1e-5, atol=1e-7)
    two = ranks[0]["test_loop"]["summary"]
    assert two.keys() == one.keys()
    for k in one:
        assert two[k] == pytest.approx(one[k], rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("name", sorted(REFUSE))
def test_main_refuses_on_every_rank_before_any_data(ranks, name):
    want = REFUSE[name][1]
    for r in ranks:
        got = r["refusals"][name]
        assert got is not None and got.startswith(want), got


def test_ranks_ran_gloo_on_the_cpu(ranks):
    assert [(r["world"], r["backend"]) for r in ranks] == [(2, "gloo")] * 2


@pytest.mark.parametrize("env", [
    {},
    {"SLURM_STEP_NODELIST": "n1", "SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    {"OMPI_COMM_WORLD_SIZE": "1", "OMPI_COMM_WORLD_RANK": "0"},
])
def test_single_process_is_noop(env, monkeypatch):
    """No launcher, or a cluster of one task: nothing is initialised and the
    port acts as one rank."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
              "SLURM_PROCID", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mesh.cluster_env() is None
    assert not mesh.maybe_initialize_distributed(Config(platform="cpu"))
    assert not mesh.distributed()
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0, True)
    assert mesh.make_mesh(3).size == 1    # one process takes any data-shard count


def test_cluster_env_reads_each_launcher():
    assert mesh.cluster_env({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}) == (3, 8, 1)
    assert mesh.cluster_env({"RANK": "0", "WORLD_SIZE": "1"}) == (0, 1, 0)
    assert mesh.cluster_env({"SLURM_STEP_NODELIST": "n[1-2]", "SLURM_NTASKS": "4",
                             "SLURM_PROCID": "2", "SLURM_LOCALID": "0"}) == (2, 4, 0)
    # a batch script's own step (no job step) is not a rank
    assert mesh.cluster_env({"SLURM_NTASKS": "4", "SLURM_PROCID": "0"}) is None
    assert mesh.cluster_env({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
                             "OMPI_COMM_WORLD_LOCAL_RANK": "1"}) == (1, 2, 1)
