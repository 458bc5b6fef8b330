"""The port's tooling held against the JAX package's, on the CPU: the
preflight (the same report, recipe and exit code for the same command line
on the same temporary trees), the three dataset tools (the same JSON and
the same copies for the same tree and seed), the kernels' build cache (the
directory it picks, as the JAX cache picks its own) and the op-level
``propagate_deformable_windowed_union`` (within 2e-4 of the JAX op, forward
and gradients, on the same inputs).
"""

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu import preflight as jax_preflight
from nlspn_eccv20_tpu.ops.propagate import (
    propagate_deformable_windowed_union as jax_union,
)
from nlspn_eccv20_tpu.tools import generate_json_kitti_dc as jax_kitti_json
from nlspn_eccv20_tpu.tools import generate_json_nyu as jax_nyu_json
from nlspn_eccv20_tpu.tools import prepare_kitti_dc as jax_prepare
from nlspn_eccv20_tpu.utils import compile_cache as jax_cache
from nlspn_eccv20_tpu_torch import preflight
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.propagate import (
    propagate_deformable_windowed_planar,
    propagate_deformable_windowed_union,
)
from nlspn_eccv20_tpu_torch.tools import (
    generate_json_kitti_dc,
    generate_json_nyu,
    prepare_kitti_dc,
)
from nlspn_eccv20_tpu_torch.utils import compile_cache


def touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb"):
        pass


def run_main(main, argv, monkeypatch, pass_argv=True):
    """A tool's ``main`` with ``argv``, its printed output and return."""
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    with contextlib.redirect_stdout(out):
        ret = main(argv) if pass_argv else main()
    return ret, out.getvalue()


# ---- preflight ----

@pytest.fixture
def nyu_tree(tmp_path):
    root = tmp_path / "nyu"
    files = [f"train/scene_{s}/{i:05d}.h5" for s in range(2) for i in range(3)]
    files += [f"val/official/{i:05d}.h5" for i in range(2)]
    for f in files:
        touch(root / f)
    splits = {"train": [{"filename": f} for f in files[:4]],
              "val": [{"filename": files[4]}], "test": [{"filename": f} for f in files[6:]]}
    with open(tmp_path / "nyu.json", "w") as f:
        json.dump(splits, f)
    return root, tmp_path / "nyu.json"


def preflight_cases(tmp_path, nyu_tree):
    root, split = nyu_tree
    base = ["--data_name", "NYU", "--dir_data", str(root), "--split_json", str(split),
            "--save_dir", str(tmp_path / "run")]
    pt = tmp_path / "weights.pt"
    torch.save({}, pt)
    os.remove(root / "train/scene_0/00001.h5")   # a sample of the split misses it
    return {
        "ready": base,
        "deep": base + ["--deep"],             # finds the removed file
        "no_json": base[:4] + ["--split_json", str(tmp_path / "none.json")] + base[6:],
        "no_dir": ["--data_name", "NYU", "--dir_data", str(tmp_path / "none"),
                   "--split_json", str(split), "--save_dir", str(tmp_path / "run")],
        "explicit_backbone": base + ["--dir_pretrain_backbone", str(tmp_path / "bb")],
        "from_scratch": base + ["--from_scratch"],
        "pretrain_file": base + ["--pretrain", str(pt)],
        "pretrain_missing": base + ["--pretrain", str(tmp_path / "nothing")],
        "test_only": base + ["--test_only"],
        "synthetic": ["--data_name", "Synthetic", "--save_dir", str(tmp_path / "run")],
    }


@pytest.mark.parametrize("case", ["ready", "deep", "no_json", "no_dir", "explicit_backbone",
                                  "from_scratch", "pretrain_file", "pretrain_missing",
                                  "test_only", "synthetic"])
def test_preflight_reports_as_jax_does(case, tmp_path, nyu_tree, monkeypatch):
    monkeypatch.chdir(tmp_path)     # the default backbone directory is relative
    argv = preflight_cases(tmp_path, nyu_tree)[case]
    got = run_main(preflight.main, argv, monkeypatch)
    want = run_main(jax_preflight.main, argv, monkeypatch)
    assert got == want
    assert got[0] == (0 if case in ("ready", "from_scratch", "pretrain_file", "test_only",
                                    "synthetic") else 1), got[1]


def test_preflight_reads_the_ports_experiment_directories(tmp_path, nyu_tree, monkeypatch):
    """A port run directory is a pretrain and a resume source; the JAX
    package's Orbax directory is refused with the reason."""
    monkeypatch.chdir(tmp_path)
    root, split = nyu_tree
    run = tmp_path / "run"
    touch(run / "ckpt" / "model_00003.pt")
    orbax = tmp_path / "orbax"
    os.makedirs(orbax / "ckpt" / "2")
    base = ["--data_name", "NYU", "--dir_data", str(root), "--split_json", str(split)]

    def report(**kw):
        c = Config(data_name="NYU", dir_data=str(root), split_json=str(split),
                   save_dir=str(run), **kw)
        return {ch.name: (ch.status, ch.detail) for ch in preflight.run_preflight(c).checks}

    assert report(pretrain=str(run))["pretrain"] == (
        "ok", f"experiment directory {run} (epoch 3)")
    status, detail = report(pretrain=str(orbax))["pretrain"]
    assert status == "FAIL" and "Orbax" in detail
    assert report(resume=True, dir_pretrain_backbone=str(tmp_path / "bb"))["backbone"] == (
        "ok", "resume restores epoch 3; backbone init skipped (main.py)")
    assert run_main(preflight.main, base + ["--pretrain", str(orbax)], monkeypatch)[0] == 1
    assert listing(run) == [".", "ckpt", os.path.join("ckpt", "model_00003.pt")]
    assert not (tmp_path / "bb").exists()


# ---- dataset tools ----

def test_nyu_json_as_jax_writes_it(tmp_path, monkeypatch):
    root = tmp_path / "nyu"
    for s in range(3):
        for i in range(7):
            touch(root / f"train/scene_{s}/{i:05d}.h5")
    for i in range(4):
        touch(root / f"val/official/{i:05d}.h5")
    outs = {}
    for name, main, pass_argv in (("port", generate_json_nyu.main, True),
                                  ("jax", jax_nyu_json.main, False)):
        path = tmp_path / f"{name}.json"
        argv = ["--path_root", str(root), "--path_out", str(path), "--val_ratio", "0.2",
                "--seed", "11", "--num_test", "3"]
        _, printed = run_main(main, argv, monkeypatch, pass_argv)
        with open(path) as f:
            outs[name] = (f.read(), printed)
    assert outs["port"] == outs["jax"]
    data = json.loads(outs["port"][0])
    assert (len(data["train"]), len(data["val"]), len(data["test"])) == (17, 4, 3)


def kitti_tree(root):
    for split, seqs in (("train", ("2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync")),
                        ("val", ("2011_09_28_drive_0003_sync",))):
        for seq in seqs:
            for cam in ("image_02", "image_03"):
                for i in range(3):
                    fn = f"{i:010d}.png"
                    touch(root / split / seq / "proj_depth" / "groundtruth" / cam / fn)
                    touch(root / split / seq / "proj_depth" / "velodyne_raw" / cam / fn)
                    if i != 2 or cam == "image_02":    # a frame without rgb is skipped
                        touch(root / split / seq / cam / "data" / fn)
            touch(root / split / seq / "calib_cam_to_cam.txt")
    for sub, gt in (("val_selection_cropped", True), ("test_depth_completion_anonymous", False)):
        base = root / "depth_selection" / sub
        for i in range(3):
            touch(base / "image" / f"x_image_{i:02d}.png")
            touch(base / "velodyne_raw" / f"x_velodyne_raw_{i:02d}.png")
            touch(base / "intrinsics" / f"x_image_{i:02d}.txt")
            if gt:
                touch(base / "groundtruth_depth" / f"x_groundtruth_depth_{i:02d}.png")


@pytest.mark.parametrize("extra", [[], ["--test_data"], ["--num_train", "4", "--seed", "3"]])
def test_kitti_json_as_jax_writes_it(extra, tmp_path, monkeypatch):
    root = tmp_path / "kitti"
    kitti_tree(root)
    outs = {}
    for name, main, pass_argv in (("port", generate_json_kitti_dc.main, True),
                                  ("jax", jax_kitti_json.main, False)):
        path = tmp_path / f"{name}.json"
        argv = ["--path_root", str(root), "--path_out", str(path), *extra]
        _, printed = run_main(main, argv, monkeypatch, pass_argv)
        with open(path) as f:
            outs[name] = (f.read(), printed)
    assert outs["port"] == outs["jax"]
    data = json.loads(outs["port"][0])
    assert len(data["test"]) == 3
    if not extra:
        assert len(data["train"]) == 10 and len(data["val"]) == 5


def raw_tree(dc, raw):
    for split, seq in (("train", "2011_09_26_drive_0001_sync"),
                       ("val", "2011_09_28_drive_0003_sync")):
        os.makedirs(dc / split / seq / "proj_depth", exist_ok=True)
        for sub in ("image_02", "image_03", "oxts"):
            touch(raw / seq[:10] / seq / sub / "data" / "0000000000.txt")
        for cf in prepare_kitti_dc.CALIB_FILES[:2]:
            touch(raw / seq[:10] / cf)
    os.makedirs(dc / "train" / "2011_09_29_drive_0009_sync")   # no raw sequence


def listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs + [""])


@pytest.mark.parametrize("dry_run", [False, True])
def test_prepare_kitti_copies_as_jax_does(dry_run, tmp_path, monkeypatch):
    results = {}
    for name, main, pass_argv in (("port", prepare_kitti_dc.main, True),
                                  ("jax", jax_prepare.main, False)):
        dc, raw = tmp_path / name / "dc", tmp_path / name / "raw"
        raw_tree(dc, raw)
        argv = ["--path_dc", str(dc), "--path_raw", str(raw)] + ["--dry_run"] * dry_run
        _, printed = run_main(main, argv, monkeypatch, pass_argv)
        results[name] = (listing(dc), printed.replace(str(tmp_path / name), "<tree>"))
    assert results["port"] == results["jax"]
    assert results["port"][1].endswith("copied 10 items\n")   # dry runs count too
    copied = os.path.join("train", "2011_09_26_drive_0001_sync", "oxts", "data",
                          "0000000000.txt")
    assert (copied in results["port"][0]) != dry_run


# ---- the build cache ----

@pytest.mark.parametrize("arg,env", [("given", ""), ("", "from_env"), ("given", "from_env")])
def test_compile_cache_picks_the_directory_jax_picks(arg, env, tmp_path, monkeypatch):
    """The same precedence as the JAX cache: the argument, then
    ``NLSPN_COMPILE_CACHE``; the kernels' build directory becomes it."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(jax_cache, "_enabled_dir", None)
    set_by_jax = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: set_by_jax.__setitem__(k, v))
    arg = str(tmp_path / arg) if arg else ""
    if env:
        monkeypatch.setenv("NLSPN_COMPILE_CACHE", str(tmp_path / env))
    else:
        monkeypatch.delenv("NLSPN_COMPILE_CACHE", raising=False)
    got = compile_cache.enable_compilation_cache(arg)
    assert not os.path.exists(got)   # made at the first build, not here
    want = jax_cache.enable_compilation_cache(arg)
    assert got == want == set_by_jax["jax_compilation_cache_dir"]
    assert build.BUILD_DIR == got
    assert build.library_path("prop_step").startswith(got + os.sep)


def test_compile_cache_off_leaves_build(tmp_path, monkeypatch):
    default = os.path.join(os.path.dirname(build.PACKAGE_DIR), "build")
    monkeypatch.setattr(build, "BUILD_DIR", default)
    monkeypatch.setenv("NLSPN_COMPILE_CACHE", "0")
    assert compile_cache.enable_compilation_cache(str(tmp_path)) is None
    assert jax_cache.enable_compilation_cache(str(tmp_path)) is None
    assert build.BUILD_DIR == default
    monkeypatch.delenv("NLSPN_COMPILE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert compile_cache.enable_compilation_cache() == os.path.join(
        str(tmp_path), ".cache", "nlspn_eccv20_tpu_torch", "nvcc")


# ---- the windowed union op ----

@pytest.mark.parametrize("kernel,radius", [(3, 2), (5, 1)])
def test_windowed_union_matches_jax(kernel, radius):
    rng = np.random.default_rng(kernel * 10 + radius)
    b, h, w, k2 = 2, 9, 11, kernel * kernel
    feat = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    off = rng.uniform(-radius, radius, (b, h, w, 2 * k2)).astype(np.float32)
    aff = rng.standard_normal((b, h, w, k2)).astype(np.float32) / k2
    cot = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    ref, vjp = jax.vjp(lambda f, o, a: jax_union(f, o, a, kernel=kernel, radius=radius),
                       jnp.asarray(feat), jnp.asarray(off), jnp.asarray(aff))
    ref_grads = vjp(jnp.asarray(cot))

    nchw = [torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))
            .requires_grad_() for a in (feat, off, aff)]
    out = propagate_deformable_windowed_union(*nchw, kernel=kernel, radius=radius)
    out.backward(torch.from_numpy(np.transpose(cot, (0, 3, 1, 2)).copy()))

    def rel(port, want):
        want = np.transpose(np.asarray(want), (0, 3, 1, 2))
        return np.max(np.abs(port.detach().numpy() - want)) / np.max(np.abs(want))

    assert out.shape == (b, 1, h, w)
    assert rel(out, ref) <= 2e-4
    for t, g in zip(nchw, ref_grads):
        assert rel(t.grad, g) <= 2e-4
    plain = propagate_deformable_windowed_planar(nchw[0][:, 0], nchw[1], nchw[2],
                                                 kernel=kernel, radius=radius)
    assert torch.allclose(out[:, 0], plain, rtol=1e-5, atol=1e-5)
