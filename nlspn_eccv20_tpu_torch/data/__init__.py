"""Data for the port: the sparse-depth sampler and the synthetic scenes.

Counterpart of ``get_sparse_depth`` in ``nlspn_eccv20_tpu/data/__init__.py``
and of ``nlspn_eccv20_tpu/data/synthetic.py``. Samples are NHWC float32
numpy arrays as in the JAX package (rgb (H, W, 3), dep/gt (H, W, 1));
``train.Engine.put_batch`` stacks them and moves them to the device as
NCHW tensors. The NYU and KITTI loaders are not ported yet.
"""

from __future__ import annotations

import numpy as np


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
