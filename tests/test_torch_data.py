"""The port's data pipeline held against the JAX package's, on the CPU.

On small NYU (HDF5) and KITTI (16-bit PNG) trees built in ``tmp_path``, the
port's samples equal the JAX package's exactly for the same numpy
Generator seed, in train (augmented), val and test modes; so do the
transforms, the sparse sampler, the split-JSON lookup, and the loader's
batches and their order (seeds, epochs, two shards, a partial last batch,
an early exit).
"""

import dataclasses
import json
import os
import threading

import h5py
import numpy as np
import pytest
from PIL import Image

from nlspn_eccv20_tpu import data as jdata
from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.data import transforms as JT
from nlspn_eccv20_tpu.data.loader import DataLoader as JaxLoader
from nlspn_eccv20_tpu_torch import data as pdata
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.data import transforms as PT
from nlspn_eccv20_tpu_torch.data.kittidc import read_calib_file
from nlspn_eccv20_tpu_torch.data.loader import DataLoader
from nlspn_eccv20_tpu_torch.data.nyu import K_NYU
from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic

KH, KW = 60, 100          # raw KITTI frames of the fixture


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nyu")
    rng = np.random.default_rng(0)
    entries = {"train": [], "val": [], "test": []}
    for split, sub in (("train", "train/room_0001"), ("val", "train/room_0002"),
                       ("test", "val/official")):
        d = tmp / "nyu" / sub
        d.mkdir(parents=True)
        for i in range(2):
            fn = f"{i:05d}.h5"
            with h5py.File(d / fn, "w") as f:
                f.create_dataset("rgb", data=rng.integers(0, 256, (3, 120, 160),
                                                          dtype=np.uint8))
                f.create_dataset("depth", data=(rng.random((120, 160)) * 9 + 0.5)
                                 .astype(np.float32))
            entries[split].append({"filename": f"{sub}/{fn}"})
    with open(tmp / "nyu.json", "w") as f:
        json.dump(entries, f)
    return str(tmp / "nyu"), str(tmp / "nyu.json")


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kitti")
    root = tmp / "kitti"
    rng = np.random.default_rng(1)
    date = "2011_09_26"
    seq = f"{date}_drive_0001_sync"

    def frame(base, fn):
        Image.fromarray(rng.integers(0, 256, (KH, KW, 3), dtype=np.uint8)).save(
            base / "image" / fn)
        gt = (rng.random((KH, KW)) * 80 * 256).astype(np.uint16)
        Image.fromarray(gt).save(base / "gt" / fn)
        Image.fromarray((gt * (rng.random((KH, KW)) > 0.8)).astype(np.uint16)).save(
            base / "velodyne" / fn)

    entries = {"train": [], "val": [], "test": []}
    for split in ("train", "val"):
        base = root / split / seq / "image_02"
        for sub in ("image", "gt", "velodyne"):
            (base / sub).mkdir(parents=True)
        for i in range(2):
            fn = f"{i:010d}.png"
            frame(base, fn)
            rel = f"{split}/{seq}/image_02"
            # val names a calib that is not there: the date-level one is found
            k = (f"{date}/calib_cam_to_cam.txt" if split == "train"
                 else "elsewhere/calib_cam_to_cam.txt")
            entries[split].append({"rgb": f"{rel}/image/{fn}",
                                   "depth": f"{rel}/velodyne/{fn}",
                                   "gt": f"{rel}/gt/{fn}", "K": k})
    (root / date).mkdir()
    P = ("7.215377e+02 0.000000e+00 4.095593e+01 4.485728e+01 0.000000e+00 "
         "7.215377e+02 2.728540e+01 2.163791e-01 0.000000e+00 0.000000e+00 "
         "1.000000e+00 2.745884e-03")
    with open(root / date / "calib_cam_to_cam.txt", "w") as f:
        f.write(f"calib_time: 09-Jan-2012 13:57:47\nP_rect_02: {P}\nP_rect_03: {P}\n")

    base = root / "depth_selection" / "val"
    for sub in ("image", "gt", "velodyne", "intrinsics"):
        (base / sub).mkdir(parents=True)
    frame(base, "0000000000.png")
    with open(base / "intrinsics" / "0000000000.txt", "w") as f:
        f.write("721.5 0.0 40.9 0.0 721.5 27.2 0.0 0.0 1.0")
    rel = "depth_selection/val"
    entries["test"].append({"rgb": f"{rel}/image/0000000000.png",
                            "depth": f"{rel}/velodyne/0000000000.png",
                            "gt": f"{rel}/gt/0000000000.png",
                            "K": f"{rel}/intrinsics/0000000000.txt"})
    with open(tmp / "kitti.json", "w") as f:
        json.dump(entries, f)
    return str(root), str(tmp / "kitti.json")


def configs(**kw):
    return JaxConfig(**kw).finalize(), Config(**kw).finalize()


def assert_samples_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode,augment,num_sample", [
    ("train", True, 100), ("train", True, 0), ("train", False, 100),
    ("val", True, 100), ("test", True, 50)])
def test_nyu_samples_equal_jax(nyu_tree, mode, augment, num_sample):
    root, sj = nyu_tree
    jcfg, cfg = configs(data_name="NYU", dir_data=root, split_json=sj,
                        augment=augment, num_sample=num_sample)
    jds, pds = jdata.get_dataset(jcfg, mode), pdata.get_dataset(cfg, mode)
    assert len(pds) == len(jds) == 2
    for idx in range(2):
        for seed in (0, 3):
            s = pds.__getitem__(idx, np.random.default_rng(seed))
            assert s["rgb"].shape == (228, 304, 3)
            assert_samples_equal(s, jds.__getitem__(idx, np.random.default_rng(seed)))
    if mode != "train" or not augment:
        np.testing.assert_array_equal(s["K"], K_NYU)


@pytest.mark.parametrize("mode,kw", [
    ("train", dict()), ("train", dict(num_sample=30)),
    ("train", dict(top_crop=0, augment=False)), ("val", dict(num_sample=30)),
    ("test", dict()), ("test", dict(test_crop=True)),
    ("test", dict(test_crop=True, top_crop=0, num_sample=30))])
def test_kitti_samples_equal_jax(kitti_tree, mode, kw):
    root, sj = kitti_tree
    base = dict(data_name="KITTIDC", dir_data=root, split_json=sj,
                patch_height=32, patch_width=64, top_crop=8, max_depth=90.0,
                num_sample=0)
    jcfg, cfg = configs(**{**base, **kw})
    jds, pds = jdata.get_dataset(jcfg, mode), pdata.get_dataset(cfg, mode)
    for idx in range(len(jds)):
        for seed in (0, 1, 2, 5):
            s = pds.__getitem__(idx, np.random.default_rng(seed))
            assert_samples_equal(s, jds.__getitem__(idx, np.random.default_rng(seed)))
    if mode == "test":
        crop = cfg.top_crop if cfg.test_crop else 0
        assert s["gt"].shape == (KH - crop, KW, 1)


def test_kitti_hflip_moves_cx(kitti_tree):
    """Augmented samples flip about half the time; a flip moves cx to
    W - cx before the crop's shift."""
    root, sj = kitti_tree
    _, cfg = configs(data_name="KITTIDC", dir_data=root, split_json=sj,
                     patch_height=32, patch_width=64, top_crop=8, num_sample=0)
    ds = pdata.get_dataset(cfg, "train")

    def draws(seed):     # the sample's first draws: scale, degree, flip
        r = np.random.default_rng(seed)
        return r.uniform(1.0, 1.5), r.uniform(-5.0, 5.0), r.uniform(0.0, 1.0)

    flips = [draws(s)[2] > 0.5 for s in range(12)]
    assert 0 < sum(flips) < 12
    for s in range(12):
        K = ds.__getitem__(0, np.random.default_rng(s))["K"]
        scale = draws(s)[0]
        cx = (KW - 40.95593 if flips[s] else 40.95593) * scale
        # the random crop then moves cx left by w0, 0 <= w0 <= W' - 64
        w0 = cx - K[2]
        assert -1e-3 <= w0 <= int(KW * scale) - 64 + 1e-3, (s, w0)
        assert w0 == pytest.approx(round(w0), abs=1e-3)


def test_read_calib_file(kitti_tree):
    root, _ = kitti_tree
    calib = read_calib_file(os.path.join(root, "2011_09_26", "calib_cam_to_cam.txt"))
    assert set(calib) == {"P_rect_02", "P_rect_03"}      # the date line is skipped
    assert calib["P_rect_02"].shape == (12,)
    assert calib["P_rect_02"][0] == pytest.approx(721.5377)


@pytest.fixture(scope="module")
def pil_images():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    dep = (rng.random((37, 53)) * 10).astype(np.float32)
    return rgb, dep


@pytest.mark.parametrize("name,args", [
    ("resize_short_side", (24, "bilinear")), ("resize_short_side", (80, "bicubic")),
    ("resize_short_side", (30, "nearest")), ("rotate", (3.7, "nearest")),
    ("rotate", (-4.2, "bicubic")), ("center_crop", ((20, 31),)),
    ("crop", (3, 5, 17, 29)), ("hflip", ()), ("adjust_brightness", (1.3,)),
    ("adjust_contrast", (0.7,)), ("adjust_saturation", (1.2,))])
def test_transforms_equal_jax(pil_images, name, args):
    rgb, dep = pil_images
    for arr, to_pil in ((rgb, "to_pil_rgb"), (dep, "to_pil_depth")):
        if name.startswith("adjust") and to_pil == "to_pil_depth":
            continue
        got = getattr(PT, name)(getattr(PT, to_pil)(arr), *args)
        want = getattr(JT, name)(getattr(JT, to_pil)(arr), *args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_color_jitter_and_normalisation_equal_jax(pil_images):
    rgb, dep = pil_images
    for seed in range(4):
        got = PT.color_jitter(PT.to_pil_rgb(rgb), np.random.default_rng(seed))
        want = JT.color_jitter(JT.to_pil_rgb(rgb), np.random.default_rng(seed))
        np.testing.assert_array_equal(PT.rgb_to_normalized(got),
                                      JT.rgb_to_normalized(want))
    np.testing.assert_array_equal(PT.depth_to_array(PT.to_pil_depth(dep)),
                                  JT.depth_to_array(JT.to_pil_depth(dep)))


@pytest.mark.parametrize("num_sample", [0, 10, 400, 10_000])
def test_sparse_depth_equals_jax(num_sample):
    rng = np.random.default_rng(3)
    dep = ((rng.random((30, 40, 1)) > 0.3) * rng.random((30, 40, 1))).astype(np.float32)
    got = pdata.get_sparse_depth(dep, num_sample, np.random.default_rng(4))
    np.testing.assert_array_equal(
        got, jdata.get_sparse_depth(dep, num_sample, np.random.default_rng(4)))
    assert np.count_nonzero(got) == min(num_sample, np.count_nonzero(dep > 1e-4))


@pytest.mark.parametrize("path", ["data_json/nyu.json", "data_json/missing.json",
                                  "/abs/missing.json"])
def test_resolve_split_json_equals_jax(path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)          # not the repository root
    got = pdata.resolve_split_json(path)
    assert got == jdata.resolve_split_json(path)
    assert os.path.isfile(got) == (path == "data_json/nyu.json")


def test_get_dataset_names():
    _, cfg = configs(data_name="Synthetic", patch_height=16, patch_width=24)
    assert isinstance(pdata.get_dataset(cfg, "val"), Synthetic)
    assert isinstance(pdata.get_dataset(cfg, "val"), pdata.BaseDataset)
    with pytest.raises(NotImplementedError):
        pdata.get_dataset(dataclasses.replace(cfg, data_name="Other"), "val")
    with pytest.raises(NotImplementedError):
        Synthetic(cfg, "dev")


SYN = dict(data_name="Synthetic", patch_height=12, patch_width=16, num_sample=20)


def batches(loader, epochs=(0,), stop=None):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        for i, b in enumerate(loader):
            if stop is not None and i == stop:
                break
            out.append(b)
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, drop_last=True, seed=0),
    dict(batch_size=4, shuffle=True, drop_last=True, seed=7240),
    dict(batch_size=5, shuffle=True, drop_last=False, seed=3),
    dict(batch_size=3, shuffle=False, drop_last=False, seed=1),
    dict(batch_size=5, shuffle=True, drop_last=False, seed=2, num_shards=2,
         shard_index=0),
    dict(batch_size=5, shuffle=True, drop_last=False, seed=2, num_shards=2,
         shard_index=1),
    dict(batch_size=4, shuffle=True, drop_last=True, seed=2, num_shards=2,
         shard_index=1)])
def test_loader_batches_equal_jax(kw):
    jcfg, cfg = configs(**SYN)
    for mode in ("train", "val"):
        port = DataLoader(Synthetic(cfg, mode), num_threads=3, **kw)
        ref = JaxLoader(jdata.get_dataset(jcfg, mode), num_threads=2, **kw)
        assert len(port) == len(ref)
        got, want = batches(port, (1, 2)), batches(ref, (1, 2))
        assert len(got) == len(want) == 2 * len(ref)
        for g, w in zip(got, want):
            assert_samples_equal(g, w)


def test_loader_reshuffles_by_epoch_and_exits_early():
    _, cfg = configs(**SYN)
    loader = DataLoader(Synthetic(cfg, "train"), 4, shuffle=True, seed=0,
                        num_threads=2, prefetch=1)
    e1, e2 = batches(loader, (1,)), batches(loader, (2,))
    assert not np.array_equal(e1[0]["gt"], e2[0]["gt"])
    assert all(np.array_equal(a["gt"], b["gt"]) for a, b in zip(e1, batches(loader, (1,))))
    before = threading.active_count()
    for _ in range(3):                   # leave the iterator after one batch
        assert len(batches(loader, (1,), stop=1)) == 1
    assert threading.active_count() == before


def test_loader_raises_a_failed_sample():
    class Broken(pdata.BaseDataset):
        def __len__(self):
            return 6

        def __getitem__(self, idx, rng):
            if idx == 4:
                raise IOError("unreadable sample 4")
            return {"x": np.zeros(2, np.float32)}

    _, cfg = configs(**SYN)
    with pytest.raises(IOError, match="sample 4"):
        list(DataLoader(Broken(cfg, "train"), 2, num_threads=2))
