"""The port's command line end to end on the CPU (``--platform cpu``, the
synthetic scenes, small patches).

Mirrors ``tests/test_train_smoke.py``: the artifacts of a run, a resume
that continues the LR curve (and one from a weights-only checkpoint), the
refusal of a changed ``steps_per_epoch``; then two runs with one seed
write the same ``loss_train.txt``, ``--profile`` writes a trace and a test
run writes its images. ``test_torch_main_jax.py`` holds the same path
against the JAX package's.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu_torch import main as pmain
from nlspn_eccv20_tpu_torch.config import Config, parse_args
from nlspn_eccv20_tpu_torch.utils.optim import make_lr_schedule


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU training: the suite runs
    several workers at once on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_main_end_to_end(tmp_path):
    cfg = parse_args([
        "--platform", "cpu", "--data_name", "Synthetic", "--test_pipeline",
        "--epochs", "2", "--batch_size", "2", "--patch_height", "32",
        "--patch_width", "48", "--prop_time", "2", "--GRU_hidden_dim", "16",
        "--GRU_input_dim", "16", "--num_sample", "50", "--num_threads", "2",
        "--save", "smoke", "--experiments_dir", str(tmp_path / "exp")])
    summary = pmain.main(cfg)
    for name in ("args.json", "loss_train.txt", "metric_train.txt", "loss_val.txt",
                 "metric_val.txt", "metric_test.txt"):
        assert os.path.exists(os.path.join(cfg.save_dir, name)), name
    assert glob.glob(os.path.join(cfg.save_dir, "ckpt", "model_00002.pt"))
    assert len(glob.glob(os.path.join(cfg.save_dir, "ckpt", "*"))) == 1
    assert os.path.isdir(os.path.join(cfg.save_dir, "code", "nlspn_eccv20_tpu_torch"))
    assert not glob.glob(os.path.join(cfg.save_dir, "code", "**", "*.so"), recursive=True)
    with open(os.path.join(cfg.save_dir, "metric_test.txt")) as f:
        assert "RMSE" in f.read()
    with open(os.path.join(cfg.save_dir, "loss_train.txt")) as f:
        assert [ln[:4] for ln in f.read().splitlines()] == ["0001", "0002"]
    assert set(summary) == {"RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"}
    assert all(np.isfinite(v) for v in summary.values())


def _small_cfg(exp_dir, **kw):
    base = dict(data_name="Synthetic", patch_height=32, patch_width=48,
                prop_time=1, batch_size=8, lr=1e-3, epochs=1, use_GRU=False,
                use_S2D=False, num_sample=50, num_threads=2, save="resume_t",
                experiments_dir=str(exp_dir), save_dir=os.path.join(exp_dir, "run"),
                decay="2,3", gamma="1.0,0.2", platform="cpu")
    base.update(kw)
    return Config(**base).finalize()


def _first_lr(out, epoch):
    lines = [ln for ln in out.splitlines() if f"Epoch {epoch:4d}/" in ln]
    assert lines, out
    return float(lines[0].split("lr")[1].split("|")[0].strip())


def test_resume_continues_lr_curve(tmp_path, capsys):
    """4 steps an epoch (32 / 8); the resumed epoch starts at the schedule's
    value at the checkpointed step, with the optimizer's state restored."""
    cfg = _small_cfg(tmp_path)
    first = pmain.train(cfg, "cpu")
    cfg2 = _small_cfg(tmp_path, resume=True, epochs=2)
    second = pmain.train(cfg2, "cpu")
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    assert _first_lr(out, 2) == pytest.approx(make_lr_schedule(cfg2, 4)(4), rel=1e-6)
    assert second.step == 8
    state = second.optimizer.state_dict()["state"]
    assert all(int(s["step"]) == 8 for s in state.values())
    assert first.step == 4


def test_weights_only_resume_restarts_the_optimizer(tmp_path, capsys):
    pmain.train(_small_cfg(tmp_path, save_full=False, test_pipeline=True), "cpu")
    # epoch 1 of 1 is the final one, so it was saved in full: save a
    # weights-only one as a non-final epoch would be
    from nlspn_eccv20_tpu_torch.utils.checkpoint import CheckpointManager

    ckpt = CheckpointManager(_small_cfg(tmp_path))
    full = ckpt.restore()
    ckpt.save(1, full, full=False)
    eng = pmain.train(_small_cfg(tmp_path, resume=True, epochs=2, test_pipeline=True),
                      "cpu")
    out = capsys.readouterr().out
    assert "State dicts for resume are not saved. Use --save_full argument" in out
    assert eng.step == 5      # restarted at 1 x 4 steps, then one (--test_pipeline)


def test_resume_rejects_changed_steps_per_epoch(tmp_path):
    pmain.train(_small_cfg(tmp_path, test_pipeline=True), "cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        pmain.train(_small_cfg(tmp_path, resume=True, epochs=2, batch_size=4), "cpu")


def test_one_seed_one_loss_curve(tmp_path):
    logs = []
    for run, seed in (("a", 11), ("b", 11), ("c", 12)):
        cfg = _small_cfg(tmp_path, seed=seed, save_dir=str(tmp_path / run),
                         test_pipeline=True)
        pmain.train(cfg, "cpu")
        with open(os.path.join(cfg.save_dir, "loss_train.txt"), "rb") as f:
            logs.append(f.read())
    assert logs[0] == logs[1] and logs[0].startswith(b"0001 | L1: ")
    assert logs[2] != logs[0]


def test_profile_writes_a_trace(tmp_path):
    cfg = _small_cfg(tmp_path, profile=True)
    pmain.train(cfg, "cpu")
    assert os.path.getsize(os.path.join(cfg.profile_dir, "trace.json")) > 0


def test_test_only_writes_images_and_submission_pngs(tmp_path):
    cfg = _small_cfg(tmp_path, prop_time=2, test_pipeline=True)
    pmain.train(cfg, "cpu")
    for flag, pattern in (("save_image", "00000000/05_pred_final.png"),
                          ("save_result_only", "0000000000.png")):
        out = str(tmp_path / flag)
        pmain.main(dataclasses.replace(cfg, test_only=True, pretrain=cfg.save_dir,
                                       save_dir=out, **{flag: True}))
        assert os.path.exists(os.path.join(out, "test", "epoch0000", pattern))
