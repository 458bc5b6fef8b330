"""NYU Depth V2 from HDF5 (counterpart of ``nlspn_eccv20_tpu/data/nyu.py``,
the same geometry, augmentation and intrinsics).

Raw frames are resized to short side 240 (240x320), then center-cropped to
228x304; the intrinsics are the halved Kinect parameters with the crop's
shift. Train augmentation: hflip (p=.5), rotation U(-5, 5) NEAREST, scale
s ~ U(1, 1.5) with depth / s and fx, fy * s, ColorJitter(.4, .4, .4),
center crop, ImageNet normalisation. The sparse input keeps ``num_sample``
random valid pixels. ``h5py`` is imported where a frame is read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nlspn_eccv20_tpu_torch.data import (BaseDataset, get_sparse_depth,
                                         resolve_split_json)
from nlspn_eccv20_tpu_torch.data import transforms as T

# Halved Kinect intrinsics and the center crop's principal-point shift.
K_NYU = np.asarray(
    [
        5.1885790117450188e+02 / 2.0,
        5.1946961112127485e+02 / 2.0,
        3.2558244941119034e+02 / 2.0 - 8.0,
        2.5373616633400465e+02 / 2.0 - 6.0,
    ],
    np.float32,
)


class NYU(BaseDataset):
    HEIGHT, WIDTH = 240, 320
    CROP = (228, 304)

    def __init__(self, cfg, mode):
        super().__init__(cfg, mode)
        with open(resolve_split_json(cfg.split_json)) as f:
            self.sample_list = json.load(f)[mode]
        self.augment = cfg.augment

    def __len__(self):
        return len(self.sample_list)

    def __getitem__(self, idx, rng: np.random.Generator):
        import h5py

        path = os.path.join(self.cfg.dir_data, self.sample_list[idx]["filename"])
        with h5py.File(path, "r") as f:
            rgb_raw = np.asarray(f["rgb"]).transpose(1, 2, 0)  # (H, W, 3)
            dep_raw = np.asarray(f["depth"])  # (H, W)

        rgb = T.to_pil_rgb(rgb_raw)
        dep = T.to_pil_depth(dep_raw)
        K = K_NYU.copy()

        if self.augment and self.mode == "train":
            scale = float(rng.uniform(1.0, 1.5))
            target = int(self.HEIGHT * scale)
            degree = float(rng.uniform(-5.0, 5.0))
            flip = float(rng.uniform(0.0, 1.0))

            if flip > 0.5:
                rgb, dep = T.hflip(rgb), T.hflip(dep)

            rgb = T.rotate(rgb, degree, "nearest")
            dep = T.rotate(dep, degree, "nearest")

            rgb = T.resize_short_side(rgb, target, "bilinear")
            rgb = T.color_jitter(rgb, rng)
            rgb = T.center_crop(rgb, self.CROP)

            dep = T.resize_short_side(dep, target, "bilinear")
            dep = T.center_crop(dep, self.CROP)

            rgb_arr = T.rgb_to_normalized(rgb)
            dep_arr = T.depth_to_array(dep) / scale
            K[0] *= scale
            K[1] *= scale
        else:
            rgb = T.center_crop(T.resize_short_side(rgb, self.HEIGHT, "bilinear"),
                                self.CROP)
            dep = T.center_crop(T.resize_short_side(dep, self.HEIGHT, "bilinear"),
                                self.CROP)
            rgb_arr = T.rgb_to_normalized(rgb)
            dep_arr = T.depth_to_array(dep)

        dep_sp = get_sparse_depth(dep_arr, self.cfg.num_sample, rng)
        return {"rgb": rgb_arr, "dep": dep_sp, "gt": dep_arr, "K": K}
