"""Synthetic depth-completion scenes for hermetic runs (counterpart of
``nlspn_eccv20_tpu/data/synthetic.py``): smooth procedural depth surfaces
and a correlated RGB rendering, deterministic per (split, index); the
``rng`` passed to ``__getitem__`` only draws the sparse samples.
"""

from __future__ import annotations

import numpy as np

from nlspn_eccv20_tpu_torch.data import BaseDataset, get_sparse_depth


class Synthetic(BaseDataset):
    SPLIT_SIZES = {"train": 32, "val": 8, "test": 8}

    def __init__(self, cfg, mode: str):
        super().__init__(cfg, mode)
        self.h = cfg.patch_height
        self.w = cfg.patch_width

    def __len__(self):
        return self.SPLIT_SIZES[self.mode]

    def __getitem__(self, idx, rng: np.random.Generator):
        seed = {"train": 0, "val": 10_000, "test": 20_000}[self.mode] + idx
        srng = np.random.default_rng(seed)
        h, w = self.h, self.w
        max_depth = self.cfg.max_depth

        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy /= max(h - 1, 1)
        xx /= max(w - 1, 1)
        depth = np.full((h, w), 0.3 * max_depth, np.float32)
        for _ in range(4):  # a few random smooth bumps / ramps
            cy, cx = srng.uniform(0, 1, 2)
            amp = srng.uniform(-0.2, 0.2) * max_depth
            sig = srng.uniform(0.1, 0.5)
            depth += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
        depth += srng.uniform(0.05, 0.3) * max_depth * xx
        depth = np.clip(depth, 0.1, max_depth).astype(np.float32)

        rgb = np.stack([
            depth / max_depth,
            1.0 - depth / max_depth,
            0.5 + 0.1 * srng.standard_normal((h, w)).astype(np.float32),
        ], axis=-1)
        rgb = ((rgb - 0.5) * 2.0).astype(np.float32)

        gt = depth[..., None]
        num = self.cfg.num_sample if self.cfg.num_sample > 0 else 500
        dep_sp = get_sparse_depth(gt, num, rng)

        K = np.asarray([w, w, w / 2.0, h / 2.0], np.float32)
        return {"rgb": rgb, "dep": dep_sp, "gt": gt, "K": K}

    def batch(self, indices, rng: np.random.Generator):
        """Stack the samples of ``indices`` into NHWC arrays."""
        items = [self.__getitem__(i, rng) for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
