"""The one traffic generator: scenes, training batches and serving
requests from a traffic file's parameters and the run's seed.

A scene is a smooth depth surface (a few Gaussian bumps on a ramp, in the
file's ``depth_range`` metres) and an RGB rendering of it with noise, as
uint8. Sparse depth keeps ``num_sample`` valid pixels of each scene (NYU's
rule) or each pixel with probability ``density`` (a LiDAR's share, KITTI's
``velodyne_raw``). Every seed gives the same sizes and counts; only the
content and the order change.

Training batches are NHWC float32 arrays {rgb (ImageNet-normalised), dep,
gt}, as a data loader hands them to ``Engine.put_train_batch``. Serving
requests are lists of ``frames`` uint8 (H, W, 3) images and (H, W) float32
sparse depths, as a client hands them to ``Predictor.predict_batch``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from gpubench.reference.model import IMAGENET_MEAN, IMAGENET_STD


def scenes(rng: np.random.Generator, n: int, h: int, w: int,
           depth_range: Tuple[float, float]) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb uint8 (n, h, w, 3), depth float32 (n, h, w))."""
    lo, hi = depth_range
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[None, :, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, None, :]
    span = hi - lo
    depth = np.full((n, h, w), lo + 0.3 * span, np.float32)
    for _ in range(4):
        cy, cx, amp, sig = (rng.uniform(a, b, (n, 1, 1)).astype(np.float32)
                            for a, b in ((0, 1), (0, 1), (-0.25, 0.25), (0.1, 0.5)))
        depth += amp * span * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    depth += rng.uniform(0.05, 0.4, (n, 1, 1)).astype(np.float32) * span * xx
    depth = np.clip(depth, lo, hi)
    t = (depth - lo) / span
    noise = rng.standard_normal((n, h, w, 3), dtype=np.float32) * 0.08
    rgb = np.stack([t, 1.0 - t, 0.5 + 0.3 * (t - 0.5) ** 2], -1) + noise
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8), depth


def sparse(rng: np.random.Generator, depth: np.ndarray, traffic: Dict) -> np.ndarray:
    """The observed depth: ``num_sample`` pixels of each scene, or each pixel
    with probability ``density``; zero elsewhere."""
    n, h, w = depth.shape
    keep = np.zeros((n, h * w), bool)
    if "num_sample" in traffic:
        for i in range(n):
            keep[i, rng.choice(h * w, traffic["num_sample"], replace=False)] = True
    else:
        keep = rng.random((n, h * w)) < traffic["density"]
    return np.where(keep.reshape(n, h, w), depth, 0.0).astype(np.float32)


def normalise(rgb_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB scaled to [0, 1] and normalised with the ImageNet statistics."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (rgb_u8.astype(np.float32) / 255.0 - mean) / std


def train_pool(traffic: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """``pool`` batches of ``batch`` scenes, every row its own scene."""
    rng = np.random.default_rng([int(seed), 1])
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    out = []
    for _ in range(traffic["pool"]):
        rgb, depth = scenes(rng, b, h, w, tuple(traffic["depth_range"]))
        out.append({"rgb": normalise(rgb), "dep": sparse(rng, depth, traffic)[..., None],
                    "gt": depth[..., None]})
    return out


def serve_pool(traffic: Dict, seed: int) -> List[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """``pool`` requests of ``frames`` frames each, every frame its own scene."""
    rng = np.random.default_rng([int(seed), 2])
    f, h, w = traffic["frames"], traffic["height"], traffic["width"]
    out = []
    for _ in range(traffic["pool"]):
        rgb, depth = scenes(rng, f, h, w, tuple(traffic["depth_range"]))
        dep = sparse(rng, depth, traffic)
        out.append((list(rgb), list(dep)))
    return out


def order(traffic: Dict, seed: int) -> Iterator[int]:
    """The pool's items in this seed's order, one shuffled pass after
    another, without end."""
    rng = np.random.default_rng([int(seed), 3])
    while True:
        yield from (int(i) for i in rng.permutation(traffic["pool"]))
