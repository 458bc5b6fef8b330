"""The port's binding of the native data-loading core (``native/dataloader.cc``).

Each test builds the library into its own directory under ``tmp_path``, so
the tests do not depend on whether another process built it first; three
processes that build into one empty directory at once all load a working
library (the build holds a file lock and moves the finished file into
place). The tests skip only where ``g++`` or libpng's header is missing.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from nlspn_eccv20_tpu_torch.data import kittidc, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_toolchain():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if not os.path.exists("/usr/include/png.h"):
        pytest.skip("libpng's header is not installed")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    _need_toolchain()
    out = native.load(str(tmp_path_factory.mktemp("native")))
    assert out is not None, native.unavailable_reason()
    return out


@pytest.fixture(scope="module")
def depth_png(tmp_path_factory):
    rng = np.random.default_rng(0)
    raw = (rng.random((40, 60)) * 80 * 256).astype(np.uint16)
    path = str(tmp_path_factory.mktemp("png") / "depth.png")
    Image.fromarray(raw).save(path)
    return path, raw.astype(np.float32) / 256.0


@pytest.fixture(scope="module")
def rgb_png(tmp_path_factory):
    img = np.random.default_rng(1).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("png") / "rgb.png")
    Image.fromarray(img).save(path)
    return path, img


def test_build_is_named_by_its_source_and_reused(lib, tmp_path):
    out_dir = os.path.dirname(lib.path)
    assert lib.path == native.library_path(out_dir)
    assert os.path.dirname(native.library_path()) == os.path.join(REPO, "build", "native")
    mtime = os.path.getmtime(lib.path)
    assert native.build(out_dir) == lib.path
    assert os.path.getmtime(lib.path) == mtime
    assert not [f for f in os.listdir(out_dir) if f.endswith(".tmp")]


def test_depth_decode_matches_pil(lib, depth_png):
    path, gold = depth_png
    assert lib.png_dims(path) == gold.shape
    np.testing.assert_array_equal(lib.decode_depth_png(path), gold)
    np.testing.assert_array_equal(
        np.array(Image.open(path)).astype(np.float32) / 256.0, gold)


def test_rgb_decode_fuses_the_normalisation(lib, rgb_png):
    path, img = rgb_png
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    gold = (np.asarray(Image.open(path), np.float32) / 255.0 - mean) / std
    np.testing.assert_allclose(lib.decode_rgb_norm(path, 32, 48), gold, atol=1e-5)
    batch = lib.decode_rgb_batch([path, path], 32, 48, num_threads=2)
    assert batch.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(batch[1], gold, atol=1e-5)


def test_batch_decode(lib, depth_png, tmp_path):
    path, gold = depth_png
    out = lib.decode_depth_batch([path] * 3, 40, 60)
    assert out.shape == (3, 40, 60)
    for i in range(3):
        np.testing.assert_array_equal(out[i], gold)
    with pytest.raises(IOError, match="1/2 depth"):
        lib.decode_depth_batch([path, str(tmp_path / "missing.png")], 40, 60)
    with pytest.raises(IOError):
        lib.png_dims(str(tmp_path / "missing.png"))


def test_sparse_sample_is_exact_and_seeded(lib):
    dep = (np.random.default_rng(2).random((50, 50)) * 10).astype(np.float32)
    a = lib.sparse_sample(dep, 123, seed=42)
    assert (a > 0).sum() == 123
    np.testing.assert_array_equal(a, lib.sparse_sample(dep, 123, seed=42))
    assert not np.array_equal(a, lib.sparse_sample(dep, 123, seed=43))
    np.testing.assert_array_equal(a[a > 0], dep[a > 0])
    few = np.zeros((10, 10, 1), np.float32)
    few[0, :3] = 1.0
    out = lib.sparse_sample(few, 50, seed=0)
    assert out.shape == (10, 10, 1) and (out > 0).sum() == 3


def test_three_processes_build_one_directory_at_once(tmp_path, depth_png):
    _need_toolchain()
    path, gold = depth_png
    out_dir = str(tmp_path / "shared")
    code = ("import sys; from nlspn_eccv20_tpu_torch.data import native; "
            "lib = native.load(sys.argv[1]); "
            "assert lib is not None, native.unavailable_reason(sys.argv[1]); "
            "print(float(lib.decode_depth_png(sys.argv[2]).sum()))")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, out_dir, path], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert float(out) == pytest.approx(float(gold.sum()), rel=1e-6)
    # one library, no temporary file left behind
    assert sorted(os.listdir(out_dir)) == sorted(
        [".lock", os.path.basename(native.library_path(out_dir))])


def test_a_failed_build_is_reported_not_raised(tmp_path, monkeypatch):
    _need_toolchain()
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    out_dir = str(tmp_path / "out")
    assert native.load(out_dir) is None
    assert not native.available(out_dir)
    assert native.unavailable_reason(out_dir).startswith("g++ failed")
    assert not os.path.exists(native.library_path(out_dir))


def test_kitti_reads_depth_with_pil_without_the_library(depth_png, monkeypatch):
    path, gold = depth_png
    monkeypatch.setattr(native, "available", lambda *a: False)
    np.testing.assert_array_equal(kittidc.read_depth_png(path), gold)
    eight_bit = os.path.join(os.path.dirname(path), "eight.png")
    Image.fromarray(np.full((4, 4), 200, np.uint16)).save(eight_bit)
    with pytest.raises(ValueError, match="8-bit"):
        kittidc.read_depth_png(eight_bit)
