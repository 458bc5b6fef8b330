"""The harness without a card: a configuration, a traffic mix and metrics
added as new files are found by name; a run that finds no card, or no
port beside it, fails and prints no result; the runs of every cell, cut
to a CPU size, come out correct, and each fault the cells can have
(a step that leaves the state unchanged, half of each batch left out,
an answer altered where it is made) and the TF32 control come out not
correct; the trace reading and the isolation check."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gpubench import bench, calibrate, check, run
from gpubench.cells import Card, Reading, Window
from gpubench.trace import DeviceTrace, Spans, bare_name, group_of, port_kernel_names

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("fork_nyu_train", "eccv20_nyu_train", "eccv20_kitti_serve", "fork_nyu_serve")


def digest(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = hashlib.sha1(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "gpubench"
    shutil.copytree(os.path.join(ROOT, "gpubench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = digest(here)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    config = json.loads((here / "configs" / "nlspn_fork.json").read_text())
    config["config"].update(prop_time=2, GRU_hidden_dim=8, GRU_input_dim=8)
    (here / "configs" / "nlspn_small.json").write_text(json.dumps(config))
    traffic = json.loads((here / "traffic" / "nyu_train_b12.json").read_text())
    traffic.update(batch=2, height=24, width=40, pool=6, num_sample=30)
    (here / "traffic" / "small_train.json").write_text(json.dumps(traffic))
    (here / "limits" / "small.train.json").write_text(json.dumps(
        {"loss_gap": 1e-3, "grad_gap_worst": 0.1, "change_gap_median": 0.1}))
    (here / "e2e" / "step_ms.py").write_text(
        'def read(w):\n    return 1e3 * w.seconds / w.units\n')
    (here / "metrics" / "steps_traced.train.py").write_text(
        'def read(r):\n    return r.trace.units if r.trace is not None else None\n')
    spec["configs"].append({"name": "nlspn_small", "source": "a test", "reduced": [],
                            "file": "gpubench/configs/nlspn_small.json", "why": "a test"})
    spec["workloads"].append({"name": "small.train", "config": "nlspn_small",
                              "traffic": "small_train", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "step_ms", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["small.train"]})
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "training engine", "moves": "step_ms",
                              "workloads": ["small.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before
    cell, _ = bench.load(str(tmp_path), "small.train", here=str(here))
    assert cell.config["config"]["GRU_hidden_dim"] == 8 and cell.traffic["height"] == 24
    assert [m.name for m in cell.end_to_end] == ["peak_mem_gib", "setup_s", "step_ms"]
    assert [m.name for m in cell.per_layer] == ["steps_traced.train"]
    out, _ = run.run_cell(cell, 2**31 + 7, 0.2, False, Card("cpu"), time.perf_counter())
    assert out["correct"] and out["metrics"]["step_ms"]["value"] > 0
    out, _ = run.run_cell(cell, 2**31 + 7, 0.2, True, Card("cpu"), time.perf_counter())
    assert out["metrics"] == {"steps_traced.train": {"value": traffic["trace_units"],
                                                     "unit": "steps"}}
    assert list(out)[-1] == "checks"


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "fork_nyu_train", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_port_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    done = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                           "eccv20_kitti_serve", "--seed", "3", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


def drive(cell, seed=2**31 + 21):
    return run.run_cell(cell, seed, 0.2, False, Card("cpu"), time.perf_counter())[0]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(tiny_cell, workload):
    out = drive(tiny_cell(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", ("fork_nyu_train", "eccv20_nyu_train"))
def test_a_step_that_keeps_the_state_is_not_correct(tiny_cell, monkeypatch, workload):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = drive(tiny_cell(workload))
    assert not out["correct"]
    assert out["checks"]["change_gap_median"]["value"] == pytest.approx(1.0, rel=1e-2)


@pytest.mark.parametrize("workload", ("fork_nyu_train", "eccv20_nyu_train"))
def test_half_of_the_batch_is_not_correct(tiny_cell, monkeypatch, workload):
    from nlspn_eccv20_tpu_torch.train import Engine

    put = Engine.put_train_batch
    monkeypatch.setattr(Engine, "put_train_batch", lambda self, batch: put(
        self, {k: v[:len(v) // 2] for k, v in batch.items()}))
    assert not drive(tiny_cell(workload))["correct"]


@pytest.mark.parametrize("workload", ("eccv20_kitti_serve", "fork_nyu_serve"))
def test_an_altered_answer_is_not_correct(tiny_cell, monkeypatch, workload):
    from nlspn_eccv20_tpu_torch.serve import Predictor

    predict = Predictor.predict_batch

    cell = tiny_cell(workload)
    lo, hi = cell.traffic["depth_range"]
    # one pixel of ordinary depth (the answer's median), off by twice the limit
    by = 2 * cell.limits["depth_gap"] * (hi - lo)

    def altered(self, rgbs, deps):
        out = predict(self, rgbs, deps)
        out[0] = out[0].copy()
        flat = out[0].reshape(-1)
        flat[np.argsort(flat)[flat.size // 2]] += by
        return out

    monkeypatch.setattr(Predictor, "predict_batch", altered)
    out = drive(cell)
    assert not out["correct"]
    assert out["checks"]["depth_gap"]["value"] == pytest.approx(2 * cell.limits["depth_gap"],
                                                                rel=0.1)


@pytest.mark.parametrize("workload", ("eccv20_kitti_serve", "eccv20_nyu_train"))
def test_weights_that_amplify_are_not_correct(tiny_cell, monkeypatch, workload):
    # raw affinities of both signs, as plain random weights draw them: the
    # propagation then grows past the scene's far end, and the run is not
    # correct whatever the program's gaps read
    from gpubench import cells
    from gpubench.reference import weights

    def both_signs(c, seed, device):
        w = weights.make_weights(c, seed, device)
        aff = slice(2 * weights.neighbours(c) if c.offset else 0, None)
        w["off_aff_dec0.0.weight"][aff] *= 400.0
        w["off_aff_dec0.0.bias"][aff] = 0.0
        return w

    monkeypatch.setattr(cells, "make_weights", both_signs)
    cell = tiny_cell(workload)
    cell.config["config"]["prop_time"] = 18
    out = drive(cell)
    assert out["checks"]["depth_excess"]["value"] > 0 and not out["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct(tiny_cell, workload):
    cell = tiny_cell(workload)
    train = cell.traffic["kind"] == "train"
    control = calibrate.control_train if train else calibrate.control_serve
    found = control(cell, 5, Card("cpu"))
    numbers = {k: found["control_tf32_emulated"][k] for k in cell.limits}
    assert not check.judge(numbers, cell.limits)[0], numbers


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct_on_the_card(card, workload):
    # the cell's own widths and frames (cuDNN takes TF32 only where its
    # tensor-core convolutions pay, so a shrunk model hides the control);
    # a training batch of 4 instead of 12
    cell = bench.load(ROOT, workload)[0]
    train = cell.traffic["kind"] == "train"
    if train:
        cell.traffic["batch"] = 4
    control = calibrate.control_train if train else calibrate.control_serve
    found = control(cell, 5, card)
    numbers = {k: found["control_tf32"][k] for k in cell.limits}
    assert not check.judge(numbers, cell.limits)[0], numbers


def test_kernel_names_and_groups():
    port = port_kernel_names(os.path.join(ROOT, "nlspn_eccv20_tpu_torch", "csrc"))
    assert {"prop_step_kernel", "prop_loop_kernel", "wgrad_s2_kernel", "deform_prop_kernel",
            "dec_aff_tail_kernel", "dep_encode_front_kernel"} <= port
    assert "__launch_bounds__" not in port
    names = {
        "void (anonymous namespace)::dec_aff_tail_kernel<8, 2>(float const*, float*)": "port",
        "(anonymous namespace)::dep_encode_front_kernel(float const*, int)": "port",
        "void bwd::wgrad_s2_kernel<float>(float const*, int)": "port",
        "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512>(float)": "batchnorm",
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": "conv",
        "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int)": "conv",
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<T>(T)": "optimizer",
        "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>(int)": "other",
    }
    assert {n: group_of(n, port) for n in names} == names
    assert bare_name("prop_step_kernel(float const*)") == "prop_step_kernel"


def test_device_trace_reading():
    port = frozenset({"prop_step_kernel"})
    kernels = [("prop_step_kernel(float const*)", 10.0, 30.0),
               ("sm80_xmma_fprop_implicit_gemm", 30.0, 80.0),
               ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float>(float)", 120.0, 130.0)]
    host = [("gpubench.make_sample", 80.0, 118.0), ("aten::copy_", 90.0, 110.0),
            ("gpubench.window", 0.0, 200.0)]
    tr = DeviceTrace(kernels, [(130.0, 140.0)], host, (0.0, 200.0), 2, port)
    assert tr.busy_s == pytest.approx(90e-6) and tr.window_s == pytest.approx(200e-6)
    assert tr.group_ms("port") == pytest.approx(0.01) and tr.group_ms("optimizer") is None
    assert tr.launches() == 1.5
    gaps = tr.idle_gaps()
    assert gaps[0] == ["host idle", pytest.approx(60e-6)]
    assert gaps[1][0] == "gpubench.make_sample > aten::copy_"
    assert gaps[2] == ["host idle", pytest.approx(10e-6)]
    reading = Reading(None, Window("serve"), tr, Spans(), "NVIDIA H100 80GB HBM3")
    assert reading.idle_share() == pytest.approx(55.0)
    assert len(tr.breakdown()["device_ops"]) == 3


def test_depth_excess():
    span = (2.0, 82.0)
    assert check.depth_excess([np.array([0.0, 82.0])], span) == 0.0
    assert check.depth_excess([np.array([1.0]), np.array([90.0])], span) == pytest.approx(0.1)
    assert check.depth_excess([np.array([-8.0, 3.0])], span) == pytest.approx(0.1)
    assert check.depth_excess([np.array([np.nan])], span) == float("inf")
    assert check.depth_gap([np.array([1.0, 5.0])], [np.array([1.0, 1.0])], span) == 0.05


def test_isolation_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    monkeypatch.setitem(sys.modules, "nlspn_eccv20_tpu_torch_extra", sys)
    base = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert run.forbidden_modules() == sorted(set(base) | {"flax"})
