"""Host-side image and depth transforms, PIL and numpy (counterpart of
``nlspn_eccv20_tpu/data/transforms.py``, the same arithmetic).

The torchvision transform semantics the reference relies on: resize of the
short side, rotation, center and random crops, horizontal flip, color
jitter, ImageNet normalisation. Depth maps use NEAREST rotation and the
reference's interpolation choices (bilinear resize on NYU, nearest on
KITTI). PIL is imported by the functions that use it, so a run on the
synthetic scenes does not need it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _resample(method: str):
    from PIL import Image

    return {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC}[method]


def to_pil_rgb(arr: np.ndarray):
    from PIL import Image

    return Image.fromarray(arr.astype(np.uint8), mode="RGB")


def to_pil_depth(arr: np.ndarray):
    from PIL import Image

    return Image.fromarray(arr.astype(np.float32), mode="F")


def resize_short_side(img, target: int, method: str):
    """torchvision T.Resize(int): scale the SHORT side to ``target``."""
    w, h = img.size
    if h <= w:
        nh, nw = target, max(1, int(round(target * w / h)))
    else:
        nw, nh = target, max(1, int(round(target * h / w)))
    return img.resize((nw, nh), _resample(method))


def rotate(img, degrees: float, method: str):
    """torchvision TF.rotate: CCW rotation about the center, same size."""
    return img.rotate(degrees, resample=_resample(method))


def center_crop(img, crop_hw: Tuple[int, int]):
    ch, cw = crop_hw
    w, h = img.size
    top = int(round((h - ch) / 2.0))
    left = int(round((w - cw) / 2.0))
    return img.crop((left, top, left + cw, top + ch))


def crop(img, top: int, left: int, height: int, width: int):
    return img.crop((left, top, left + width, top + height))


def hflip(img):
    from PIL import Image

    return img.transpose(Image.FLIP_LEFT_RIGHT)


def adjust_brightness(img, factor: float):
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(img).enhance(factor)


def adjust_contrast(img, factor: float):
    from PIL import ImageEnhance

    return ImageEnhance.Contrast(img).enhance(factor)


def adjust_saturation(img, factor: float):
    from PIL import ImageEnhance

    return ImageEnhance.Color(img).enhance(factor)


def color_jitter(img, rng: np.random.Generator, brightness: float = 0.4,
                 contrast: float = 0.4, saturation: float = 0.4):
    """torchvision ColorJitter: random factors, random application order."""
    fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    ops = [(adjust_brightness, fb), (adjust_contrast, fc),
           (adjust_saturation, fs)]
    for i in rng.permutation(3):
        fn, f = ops[i]
        img = fn(img, f)
    return img


def rgb_to_normalized(img) -> np.ndarray:
    """PIL RGB -> float32 (H, W, 3), /255 then ImageNet-normalised."""
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def depth_to_array(img) -> np.ndarray:
    """PIL 'F' depth -> float32 (H, W, 1)."""
    return np.asarray(img, np.float32)[..., None]
