"""Datasets for the port: the registry, the base class and the sparse-depth
sampler (counterpart of ``nlspn_eccv20_tpu/data/__init__.py``).

Datasets are keyed by name and yield dict samples {'rgb', 'dep', 'gt', 'K'}
as NHWC float32 numpy arrays (rgb (H, W, 3), dep/gt (H, W, 1), K (4,)), the
JAX package's layout; ``data/loader.DataLoader`` stacks them and
``train.Engine.put_batch`` moves them to the device as NCHW tensors. NYU
needs ``h5py`` and KITTI ``PIL``, each imported where it is used, so that
the synthetic scenes need neither.
"""

from __future__ import annotations

import os

import numpy as np


def resolve_split_json(path: str) -> str:
    """A split-JSON path as given if it exists, else (for a relative path)
    against the repository root, where ``data_json/`` lives, so that the
    default ``--split_json data_json/nyu.json`` works from any directory."""
    if os.path.isfile(path) or os.path.isabs(path):
        return path
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(repo_root, path)
    return cand if os.path.isfile(cand) else path


class BaseDataset:
    """A map-style dataset: ``__len__`` and ``__getitem__(idx, rng)``.

    Randomness is explicit: ``__getitem__`` takes a numpy Generator, which
    the loader seeds per (seed, epoch, index), so that samples do not depend
    on the order threads load them in."""

    def __init__(self, cfg, mode: str):
        if mode not in ("train", "val", "test"):
            raise NotImplementedError(f"mode {mode}")
        self.cfg = cfg
        self.mode = mode

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx, rng: np.random.Generator):  # pragma: no cover
        raise NotImplementedError


def get_sparse_depth(dep: np.ndarray, num_sample: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Randomly keep ``num_sample`` valid depth pixels, zero the rest.
    dep: (H, W, 1)."""
    flat = dep.reshape(-1)
    idx_nnz = np.flatnonzero(flat > 1e-4)
    if len(idx_nnz) > num_sample:
        idx_nnz = idx_nnz[rng.permutation(len(idx_nnz))[:num_sample]]
    mask = np.zeros_like(flat)
    mask[idx_nnz] = 1.0
    return (flat * mask).reshape(dep.shape)


def get_dataset(cfg, mode: str) -> BaseDataset:
    from nlspn_eccv20_tpu_torch.data.kittidc import KITTIDC
    from nlspn_eccv20_tpu_torch.data.nyu import NYU
    from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic

    registry = {"NYU": NYU, "KITTIDC": KITTIDC, "Synthetic": Synthetic}
    if cfg.data_name not in registry:
        raise NotImplementedError(f"dataset {cfg.data_name}")
    return registry[cfg.data_name](cfg, mode)
