"""The port's command line held against the JAX package's on the CPU: the
JAX package's ``main.test`` on the port's checkpoint file and the port's
own give the same metric rows within 2e-4 relative, and both packages'
summaries write the same bytes (loss and metric logs, KITTI submission
PNGs, the visualization dumps) from the same rows and tensors, NCHW in
the port and NHWC in the JAX package.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu import main as jmain
from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.summary import Summary as JaxSummary
from nlspn_eccv20_tpu_torch import main as pmain
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.summary import Summary
from test_torch_main import _small_cfg


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU training: the suite runs
    several workers at once on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_jax_tests_the_port_checkpoint_alike(tmp_path):
    """The JAX package's main.test on the port's checkpoint file and the
    port's main.test give the same metric means over the Synthetic test
    split."""
    # batch 8: the JAX package evaluates the 8 test scenes in one batch of
    # its 8-device mesh, the port one by one
    cfg = _small_cfg(tmp_path, use_GRU=True, use_S2D=True, prop_time=2,
                     GRU_hidden_dim=16, GRU_input_dim=16, test_pipeline=True,
                     compile_cache=False)
    pmain.train(cfg, "cpu")
    pt = glob.glob(os.path.join(cfg.save_dir, "ckpt", "*.pt"))[0]
    test_kw = dict(dataclasses.asdict(cfg), test_pipeline=False, test_only=True,
                   pretrain=pt)
    port = pmain.main(Config(**dict(test_kw, save_dir=str(tmp_path / "pt"))))
    ref = jmain.test(JaxConfig(**dict(test_kw, save_dir=str(tmp_path / "jx"))))
    assert set(port) == set(ref)
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=2e-4, abs=1e-6), k


def _rows(seed, n, k):
    return np.random.default_rng(seed).random((n, k)).astype(np.float32) * 3


def test_summaries_write_the_same_bytes(tmp_path):
    cfg = Config(save_result_only=True, max_depth=10.0)
    loss_name = ["L1", "L2", "Total"]
    metric_name = ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"]
    dirs = {}
    for tag, cls in (("port", Summary), ("jax", JaxSummary)):
        d = str(tmp_path / tag)
        s = cls(d, "train", cfg, loss_name, metric_name)
        for e in (1, 2):
            s.add(_rows(e, 4, 3), _rows(e + 10, 4, 8))
            s.add(_rows(e + 20, 2, 3), _rows(e + 30, 2, 8))
            s.update(e)
        s.close()
        dirs[tag] = d
    for name in ("loss_train.txt", "metric_train.txt"):
        with open(os.path.join(dirs["port"], name), "rb") as a, \
                open(os.path.join(dirs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name

    pred = np.random.default_rng(3).random((2, 20, 30, 1)).astype(np.float32) * 80
    pred[0, 0, :3, 0] = [-1.0, 0.0, 255.99]
    for tag, cls, out in (("port", Summary, {"pred": torch.from_numpy(
                              pred.transpose(0, 3, 1, 2).copy())}),
                          ("jax", JaxSummary, {"pred": pred})):
        s = cls(dirs[tag], "test", cfg, None, metric_name)
        s.setup_output_dir(0)
        for i in range(2):
            s.save(0, i, None, out, batch_index=i)
        s.close()
    for i in range(2):
        name = os.path.join("test", "epoch0000", f"{i:010d}.png")
        with open(os.path.join(dirs["port"], name), "rb") as a, \
                open(os.path.join(dirs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name


def test_visualization_dumps_match_jax(tmp_path):
    """save_image's PNGs and .npy files from one sample and output, NCHW
    in the port and NHWC in the JAX package, are the same bytes."""
    rng = np.random.default_rng(4)
    b, h, w = 2, 12, 16
    nhwc = {"rgb": rng.standard_normal((b, h, w, 3)), "dep": rng.random((b, h, w, 1)) * 5,
            "gt": rng.random((b, h, w, 1)) * 5}
    out_nhwc = {"pred": rng.random((b, h, w, 1)) * 9, "pred_init": rng.random((b, h, w, 1)),
                "pred_inter": [rng.random((b, h, w, 1)) for _ in range(2)],
                "aff": rng.random((b, h, w, 8)), "offset": rng.random((b, h, w, 18)),
                "gamma": np.asarray([2.5]), "confidence": rng.random((b, h, w, 1))}
    f32 = {k: np.asarray(v, np.float32) for k, v in nhwc.items()}

    def nchw(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))))

    port_out = {k: ([nchw(p) for p in v] if k == "pred_inter" else
                    torch.from_numpy(np.asarray(v, np.float32)) if k == "gamma" else nchw(v))
                for k, v in out_nhwc.items()}
    jax_out = {k: ([np.asarray(p, np.float32) for p in v] if k == "pred_inter"
                   else np.asarray(v, np.float32)) for k, v in out_nhwc.items()}
    cfg = Config(save_image=True)
    for tag, cls, sample, out in (
            ("port", Summary, {k: nchw(v) for k, v in f32.items()}, port_out),
            ("jax", JaxSummary, f32, jax_out)):
        s = cls(str(tmp_path / tag), "test", cfg, None, ["RMSE"])
        s.save(0, 7, sample, out, batch_index=1)
        s.close()
    base = os.path.join("test", "epoch0000", "00000007")
    names = sorted(os.listdir(tmp_path / "jax" / base))
    assert sorted(os.listdir(tmp_path / "port" / base)) == names
    assert "04_pred_prop_01.png" in names and "offset.npy" in names
    for name in names:
        with open(tmp_path / "port" / base / name, "rb") as a, \
                open(tmp_path / "jax" / base / name, "rb") as b:
            assert a.read() == b.read(), name
