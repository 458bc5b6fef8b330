"""KITTI Depth Completion from 16-bit PNGs (counterpart of
``nlspn_eccv20_tpu/data/kittidc.py``, the same crops, augmentation and
intrinsics).

Depth PNGs decode as uint16 / 256 with a check that the map is not 8-bit;
the intrinsics come from the cam-to-cam calib (P_rect_02/03) for train and
val, from the per-image intrinsics file for test. ``top_crop`` removes sky
rows and moves cy. Train augmentation: top crop, hflip with cx -> W - cx,
rotation U(-5, 5) (BICUBIC rgb, NEAREST depth), color jitter, scale
s ~ U(1, 1.5) with depth / s and K * s, random crop with the K shift. Val:
top crop and random crop. Test: the top crop only with ``test_crop``.
PIL is imported where an image is read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nlspn_eccv20_tpu_torch.data import (BaseDataset, get_sparse_depth,
                                         resolve_split_json)
from nlspn_eccv20_tpu_torch.data import transforms as T


def read_depth_png(path: str) -> np.ndarray:
    """KITTI 16-bit depth PNG -> float32 meters (uint16 / 256), with the
    native decoder where it is built, else PIL."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"file not found: {path}")
    from nlspn_eccv20_tpu_torch.data import native

    if native.available():
        out = native.decode_depth_png(path)
        if not (out.max() == 0 or out.max() * 256.0 > 255):
            raise ValueError(f"depth png looks 8-bit: path={path}")
        return out
    from PIL import Image

    img = np.array(Image.open(path))
    if not (np.max(img) == 0 or np.max(img) > 255):
        raise ValueError(f"depth png looks 8-bit: max={np.max(img)}, path={path}")
    return img.astype(np.float32) / 256.0


def read_calib_file(path: str) -> dict:
    data = {}
    with open(path) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


class KITTIDC(BaseDataset):
    def __init__(self, cfg, mode):
        super().__init__(cfg, mode)
        with open(resolve_split_json(cfg.split_json)) as f:
            self.sample_list = json.load(f)[mode]
        self.augment = cfg.augment
        self.height = cfg.patch_height
        self.width = cfg.patch_width

    def __len__(self):
        return len(self.sample_list)

    def _calib_path(self, entry) -> str:
        """The entry's calib file; a cam-to-cam calib may sit in the
        sequence directory or at the date level (the sequence name starts
        with the 10-character date)."""
        dd = self.cfg.dir_data
        path = os.path.join(dd, entry["K"])
        if os.path.isfile(path) or not entry["K"].endswith("calib_cam_to_cam.txt"):
            return path
        parts = entry["rgb"].split(os.sep)
        date = parts[1][:10] if len(parts) > 1 else ""
        alts = [os.path.join(date, "calib_cam_to_cam.txt")]
        if len(parts) > 1:
            alts.insert(0, os.path.join(parts[0], parts[1], "calib_cam_to_cam.txt"))
        for alt in alts:
            if os.path.isfile(os.path.join(dd, alt)):
                return os.path.join(dd, alt)
        return path

    def _load(self, idx):
        from PIL import Image

        entry = self.sample_list[idx]
        dd = self.cfg.dir_data
        rgb = Image.open(os.path.join(dd, entry["rgb"]))
        depth = T.to_pil_depth(read_depth_png(os.path.join(dd, entry["depth"])))
        gt = T.to_pil_depth(read_depth_png(os.path.join(dd, entry["gt"])))

        path_calib = self._calib_path(entry)
        if self.mode in ("train", "val"):
            calib = read_calib_file(path_calib)
            key = "P_rect_02" if "image_02" in entry["rgb"] else "P_rect_03"
            P = np.reshape(calib[key], (3, 4))
            K = [P[0, 0], P[1, 1], P[0, 2], P[1, 2]]
        else:
            with open(path_calib) as f:
                vals = f.readline().split(" ")
            K = [float(vals[0]), float(vals[4]), float(vals[2]), float(vals[5])]

        if not rgb.size == depth.size == gt.size:
            raise ValueError(f"sizes differ in sample {idx}: rgb {rgb.size}, "
                             f"depth {depth.size}, gt {gt.size}")
        return rgb, depth, gt, list(map(float, K))

    def _top_crop(self, rgb, depth, gt, K):
        tc = self.cfg.top_crop
        if tc > 0:
            w, h = rgb.size
            rgb = T.crop(rgb, tc, 0, h - tc, w)
            depth = T.crop(depth, tc, 0, h - tc, w)
            gt = T.crop(gt, tc, 0, h - tc, w)
            K[3] = K[3] - tc
        return rgb, depth, gt, K

    def _random_crop(self, rgb, depth, gt, K, rng):
        width, height = rgb.size
        if self.height > height or self.width > width:
            raise ValueError("patch size is larger than the input size")
        h0 = int(rng.integers(0, height - self.height + 1))
        w0 = int(rng.integers(0, width - self.width + 1))
        rgb = T.crop(rgb, h0, w0, self.height, self.width)
        depth = T.crop(depth, h0, w0, self.height, self.width)
        gt = T.crop(gt, h0, w0, self.height, self.width)
        K[2] -= w0
        K[3] -= h0
        return rgb, depth, gt, K

    def __getitem__(self, idx, rng: np.random.Generator):
        rgb, depth, gt, K = self._load(idx)
        scale = 1.0

        if self.augment and self.mode == "train":
            rgb, depth, gt, K = self._top_crop(rgb, depth, gt, K)
            width, height = rgb.size

            scale = float(rng.uniform(1.0, 1.5))
            target = int(height * scale)
            degree = float(rng.uniform(-5.0, 5.0))
            flip = float(rng.uniform(0.0, 1.0))

            if flip > 0.5:
                rgb, depth, gt = T.hflip(rgb), T.hflip(depth), T.hflip(gt)
                K[2] = width - K[2]

            rgb = T.rotate(rgb, degree, "bicubic")
            depth = T.rotate(depth, degree, "nearest")
            gt = T.rotate(gt, degree, "nearest")

            rgb = T.color_jitter(rgb, rng, 0.4, 0.4, 0.4)

            rgb = T.resize_short_side(rgb, target, "bicubic")
            depth = T.resize_short_side(depth, target, "nearest")
            gt = T.resize_short_side(gt, target, "nearest")
            K = [K[0] * scale, K[1] * scale, K[2] * scale, K[3] * scale]
            rgb, depth, gt, K = self._random_crop(rgb, depth, gt, K, rng)
        elif self.mode in ("train", "val"):
            rgb, depth, gt, K = self._top_crop(rgb, depth, gt, K)
            rgb, depth, gt, K = self._random_crop(rgb, depth, gt, K, rng)
        elif self.cfg.top_crop > 0 and self.cfg.test_crop:
            rgb, depth, gt, K = self._top_crop(rgb, depth, gt, K)

        rgb_arr = T.rgb_to_normalized(rgb)
        dep_arr = T.depth_to_array(depth) / scale
        gt_arr = T.depth_to_array(gt) / scale
        if self.cfg.num_sample > 0:
            dep_arr = get_sparse_depth(dep_arr, self.cfg.num_sample, rng)

        return {"rgb": rgb_arr, "dep": dep_arr, "gt": gt_arr,
                "K": np.asarray(K, np.float32)}
