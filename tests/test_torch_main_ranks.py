"""The port's command line under two ranks on the CPU: ``python -m
nlspn_eccv20_tpu_torch.main --platform cpu`` in two processes with
torchrun's variables (gloo), on the synthetic scenes with
``--test_pipeline``, small patches. It trains one step of the global batch
(one image a rank), validates, checkpoints and tests; rank 0 writes every
artifact into one run directory, and rank 1 writes nothing (each file it
opens for writing, directory it makes or checkpoint it saves under the
experiments directory is recorded, ``torch_ranks._run_main``).
``test_torch_main.py`` keeps the one-process cases.
"""

import glob
import os

import pytest

from torch_ranks import spawn

ARGS = ["--platform", "cpu", "--data_name", "Synthetic", "--test_pipeline",
        "--epochs", "1", "--batch_size", "2", "--patch_height", "32",
        "--patch_width", "48", "--prop_time", "2", "--GRU_hidden_dim", "16",
        "--GRU_input_dim", "16", "--num_sample", "50", "--num_threads", "2",
        "--save", "ranks"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    exp = work / "exp"
    outs = spawn("main", work, ARGS + ["--experiments_dir", str(exp)])
    return work, exp, outs


def test_rank0_writes_every_artifact_in_one_run_directory(cli):
    _, exp, _ = cli
    runs = os.listdir(exp)
    assert len(runs) == 1 and runs[0].endswith("_ranks"), runs
    run = exp / runs[0]
    for name in ("args.json", "loss_train.txt", "metric_train.txt", "loss_val.txt",
                 "metric_val.txt", "metric_test.txt",
                 os.path.join("ckpt", "model_00001.pt"),
                 os.path.join("code", "nlspn_eccv20_tpu_torch", "main.py")):
        assert (run / name).exists(), name
    with open(run / "metric_test.txt") as f:
        assert len(f.read().splitlines()) == 1   # one test row
    assert not glob.glob(str(run / "ckpt" / "*.tmp"))


def test_other_ranks_write_nothing(cli):
    work, _, _ = cli
    with open(work / "writes1.txt") as f:
        assert f.read() == ""


def test_rank0_counts_the_global_batch(cli):
    _, _, outs = cli
    assert "train epoch 1: 2 images in" in outs[0]
    assert "=== Epoch" in outs[0] and "=== Epoch" not in outs[1]
    assert "test epoch 0000 | Metric" in outs[0]
